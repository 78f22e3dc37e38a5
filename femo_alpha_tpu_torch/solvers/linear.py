"""LinearSolver: one object per linearized system — preconditioned CG on
the strong-BC-constrained, lane-major matrix-free operator (the fused
constrained_matvec_T kernel on the card), or a dense f64 Cholesky solve.

Port of the CG + external-preconditioner and dense paths of
femo_alpha_tpu/solvers/linear.py::LinearSolver. The operator is a SUM of
element blocks: the cell block and, with penalty BCs, one facet block
(every facet group concatenated, on the owning cells' dofmap rows). Each
block is one application of the fused operator kernel, so with facets an
operator application is two kernel calls. The constrained operator
B = f*A*f + (1-f)*I is symmetric, so the transposed (adjoint) solve reuses
the forward matvec. The GMRES and Jacobi paths are not ported yet
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import torch

from ..assembly.assemble import make_constrained_matvec_T
from .direct import apply_bc_dense
from .krylov import cg_solve


def dense_from_blocks(ops, n_dofs):
    """The assembled (n, n) matrix of lane-major element blocks
    [(Ae (nd, nd, nc), spec with a (nc, nd) `dofmap`)]."""
    Ae0 = ops[0][0]
    A = Ae0.new_zeros((n_dofs, n_dofs))
    for Ae, spec in ops:
        dm = torch.as_tensor(spec.dofmap, dtype=torch.int64,
                             device=Ae.device).T  # (nd, nc)
        rows = dm[:, None, :].expand(Ae.shape)
        cols = dm[None, :, :].expand(Ae.shape)
        A.index_put_((rows.reshape(-1), cols.reshape(-1)), Ae.reshape(-1),
                     accumulate=True)
    return A


class LinearSolver:
    """Solve A x = b with strong-BC masking.

    ops: [(Ae (nd, nd, nc) lane-major, spec)] — the cell block first, its
    spec a space; further blocks (facets) with specs that carry a dofmap
    and lane tables (assembly/facets.py::FacetBlock). method: 'cg' (M: the
    preconditioner application v -> M^{-1} v, e.g. an MG V-cycle or the
    band Cholesky) or 'dense' (f64 Cholesky of the constrained matrix;
    raises if it is not positive definite)."""

    def __init__(self, ops, n_dofs, free_mask=None, method="cg", tol=1e-12,
                 maxiter=None, M=None):
        if method not in ("cg", "dense"):
            raise NotImplementedError(
                f"LinearSolver: method={method!r} is not ported to "
                "femo_alpha_tpu_torch yet (ROADMAP.md, Queue 1)")
        Ae0 = ops[0][0]
        self.ops = ops
        self.n = n_dofs
        self.tol = tol
        self.maxiter = maxiter or min(max(500, 10 * n_dofs), 200_000)
        self.free_mask = (torch.ones(n_dofs, dtype=Ae0.dtype,
                                     device=Ae0.device)
                          if free_mask is None else free_mask)
        self.method = method
        self.M = M
        self.last_info = None
        self._chol = None
        if method == "dense":
            A = apply_bc_dense(dense_from_blocks(ops, n_dofs),
                               self.free_mask)
            L, info = torch.linalg.cholesky_ex(A)
            if int(info) != 0:
                raise RuntimeError(
                    f"LinearSolver: the dense constrained matrix is not "
                    f"positive definite (Cholesky info {int(info)})")
            self._chol = L
        # the constrained operator, on both paths (the modal path applies
        # it on the dense one too)
        mvs = [make_constrained_matvec_T(Ae, sp, self.free_mask)
               for Ae, sp in ops]
        if len(mvs) == 1:
            self.matvec = mvs[0]
            return
        # every block adds (1-f)*x; the sum keeps it once
        extra = None
        if not bool((self.free_mask == 1).all()):
            extra = (len(mvs) - 1) * (1.0 - self.free_mask)

        def matvec(x):
            y = mvs[0](x)
            for mv in mvs[1:]:
                y = y + mv(x)
            return y if extra is None else y - extra * x

        self.matvec = matvec

    def solve(self, b):
        if self._chol is not None:
            return torch.cholesky_solve(b[:, None], self._chol)[:, 0]
        x, self.last_info = cg_solve(self.matvec, b, M=self.M, tol=self.tol,
                                     maxiter=self.maxiter)
        return x

    def solve_transpose(self, b):
        """The constrained operator is symmetric: the same solve."""
        return self.solve(b)
