"""Dense direct solves (port of femo_alpha_tpu/solvers/direct.py): the
dense scatter of element matrices, the symmetric BC elimination,
DenseSolver (factor once, solve and solve with the transpose) and
solve_spd_small, the unrolled Cholesky of tiny batched SPD systems.

LinearSolver(method="dense") factors its constrained matrix with
DenseSolver.
"""

from __future__ import annotations

import torch


def dense_from_elements(Ae, dofmap, n_dofs):
    """Scatter cell-major element matrices Ae (nc, nd, nd) with a (nc, nd)
    dofmap (array or tensor) into a dense (n, n) matrix on Ae's device."""
    nc, nd, _ = Ae.shape
    dm = torch.as_tensor(dofmap, dtype=torch.int64, device=Ae.device)
    rows = dm[:, :, None].expand(nc, nd, nd).reshape(-1)
    cols = dm[:, None, :].expand(nc, nd, nd).reshape(-1)
    A = Ae.new_zeros((n_dofs, n_dofs))
    A.index_put_((rows, cols), Ae.reshape(-1), accumulate=True)
    return A


def apply_bc_dense(A, free_mask):
    """Symmetric BC elimination on a dense matrix: identity rows and
    columns at the constrained dofs."""
    f = free_mask
    return A * f[:, None] * f[None, :] + torch.diag(1.0 - f)


class DenseSolver:
    """Factor a dense (n, n) matrix once and solve many right-hand sides,
    and with its transpose (the adjoint): a Cholesky with spd=True (which
    raises if A is not positive definite), else an LU with partial
    pivoting. b is (n,) or (n, k)."""

    def __init__(self, A, spd=False):
        self.spd = spd
        if spd:
            L, info = torch.linalg.cholesky_ex(A)
            if int(info) != 0:
                raise RuntimeError(f"DenseSolver: the matrix is not positive "
                                   f"definite (Cholesky info {int(info)})")
            self.chol = L
        else:
            self.lu, self.piv = torch.linalg.lu_factor(A)

    def _solve(self, b, adjoint):
        B = b[:, None] if b.dim() == 1 else b
        if self.spd:
            X = torch.cholesky_solve(B, self.chol)
        else:
            X = torch.linalg.lu_solve(self.lu, self.piv, B, adjoint=adjoint)
        return X[:, 0] if b.dim() == 1 else X

    def solve(self, b):
        return self._solve(b, adjoint=False)

    def solve_transpose(self, b):
        return self._solve(b, adjoint=True)


def solve_spd_small(M, b):
    """Unrolled Cholesky solve of tiny SPD systems of a fixed size (n up to
    ~6), batched over leading axes: M (..., n, n), b (..., n). Plain
    arithmetic, so it runs under every torch.func transform."""
    n = M.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    y = []
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y.append(s / L[i][i])
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)
