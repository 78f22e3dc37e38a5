"""LinearSolver: one object per linearized system — preconditioned CG or
restarted GMRES on the strong-BC-constrained, lane-major matrix-free
operator (the fused constrained_matvec_T kernel on the card), or a dense
f64 factorization (Cholesky, or LU for a non-symmetric operator).

Port of femo_alpha_tpu/solvers/linear.py::LinearSolver. The operator is a
SUM of element blocks: the cell block and, with penalty BCs, one facet
block (every facet group concatenated, on the owning cells' dofmap rows).
Each block is one application of the fused operator kernel, so with
facets an operator application is two kernel calls. The constrained
operator B = f*A*f + (1-f)*I of a symmetric A is symmetric, so the
transposed (adjoint) solve reuses the forward matvec; with
symmetric=False the transposed operator is the fused operator on the
transposed blocks Ae.permute(1, 0, 2) (made at the first transposed
solve). Without an external preconditioner M the iterative paths use
point Jacobi from the blocks' diagonals (pc="jacobi", the reference's
default) or none (pc=None).

`extra_matvec`, a linear map x -> E x beside the element blocks (the
linearization of a state-dependent extra residual), enters the operator
as f*E(f*x): one more term of the summed matvec, its transpose (by
torch.func.vjp) one more term of the transposed matvec, and its columns
part of the dense matrix before the BCs are applied. The Jacobi
diagonal leaves it out, as the reference's does.
"""

from __future__ import annotations

import torch

from ..assembly.assemble import make_constrained_matvec_T
from ..assembly.bc import lift_rhs
from torch.func import jacfwd, vjp

from .direct import DenseSolver, apply_bc_dense
from .krylov import cg_solve, gmres_solve
from .precond import jacobi_from_blocks


def dense_from_blocks(ops, n_dofs):
    """The assembled (n, n) matrix of lane-major element blocks
    [(Ae (nd, nd, nc), spec with a (nc, nd) `dofmap`)]. A cell block on
    one rank's cells (the first block, its spec a spaces.CellRange) is
    summed over the ranks by one all_reduce before the replicated blocks
    are added."""
    Ae0 = ops[0][0]
    A = Ae0.new_zeros((n_dofs, n_dofs))
    for Ae, spec in ops:
        dm = torch.as_tensor(spec.dofmap, dtype=torch.int64,
                             device=Ae.device).T  # (nd, nc)
        rows = dm[:, None, :].expand(Ae.shape)
        cols = dm[None, :, :].expand(Ae.shape)
        A.index_put_((rows.reshape(-1), cols.reshape(-1)), Ae.reshape(-1),
                     accumulate=True)
        comm = getattr(spec, "comm", None)
        if comm is not None:
            comm.all_reduce(A)
    return A


def _sum_of_blocks(ops, free_mask):
    """The constrained operator of a list of lane-major blocks: one fused
    operator per block; every block adds (1-f)*x, the sum keeps it once.
    A cell block on one rank's cells (its spec a spaces.CellRange) is the
    split operator, its identity term counted once over the ranks
    (parallel/product.py); the replicated facet blocks follow it.
    A block stored in f32 under f64 vectors (the fine operator under
    storage="f32") runs the fused operator's f32-matrix, f64-vector build:
    its f32 entries applied in f64 arithmetic, as the JAX package's
    make_matvec applies them on the CPU (its f32-arithmetic product, the
    JAX package's lane-major TPU path, does not converge on the shell;
    PERF.md)."""
    mvs = [make_constrained_matvec_T(Ae, sp, free_mask) for Ae, sp in ops]
    if len(mvs) == 1:
        return mvs[0]
    extra = None
    if not bool((free_mask == 1).all()):
        extra = (len(mvs) - 1) * (1.0 - free_mask)

    def matvec(x):
        y = mvs[0](x)
        for mv in mvs[1:]:
            y = y + mv(x)
        return y if extra is None else y - extra * x

    return matvec


def _with_extra(matvec, extra, free_mask):
    """matvec(x) + f*E(f*x)."""

    def op(x):
        return matvec(x) + free_mask * extra(free_mask * x)

    return op


def _transpose(linear_fn, n, like):
    """x -> E^T x of a linear map E on R^n (its vjp at zero)."""
    _, vjp_fn = vjp(linear_fn, like.new_zeros(n))

    def op(x):
        return vjp_fn(x)[0]

    return op


class LinearSolver:
    """Solve A x = b with strong-BC masking.

    ops: [(Ae (nd, nd, nc) lane-major, spec)] — the cell block first, its
    spec a space; further blocks (facets) with specs that carry a dofmap
    and lane tables (assembly/facets.py::FacetBlock). method: 'cg' (CG when
    symmetric, else GMRES), 'gmres' (restart 50, maxiter // 50 cycles) or
    'dense' (an f64 Cholesky of the constrained matrix, which raises if it
    is not positive definite; an LU with symmetric=False). M: an external
    preconditioner application v -> M^{-1} v (e.g. an MG V-cycle or the
    band Cholesky); without one, pc='jacobi' builds point Jacobi and
    pc=None applies none. extra_matvec: a linear map x -> E x added to the
    raw operator (see the module docstring)."""

    def __init__(self, ops, n_dofs, free_mask=None, method="cg", pc="jacobi",
                 tol=1e-12, maxiter=None, symmetric=True, M=None,
                 extra_matvec=None):
        Ae0 = ops[0][0]
        self.ops = ops
        self.n = n_dofs
        self.tol = tol
        self.symmetric = symmetric
        self.maxiter = maxiter or min(max(500, 10 * n_dofs), 200_000)
        self.free_mask = (torch.ones(n_dofs, dtype=Ae0.dtype,
                                     device=Ae0.device)
                          if free_mask is None else free_mask)
        self.method = method
        self.extra_matvec = extra_matvec
        self.last_info = None
        self._dense = None
        self._matvecT = None
        self.M = None
        if method == "dense":
            A = dense_from_blocks([(Ae.to(self.free_mask.dtype), sp)
                                   for Ae, sp in ops], n_dofs)
            if extra_matvec is not None:
                A = A + jacfwd(extra_matvec)(A.new_zeros(n_dofs))
            self._dense = DenseSolver(apply_bc_dense(A, self.free_mask),
                                      spd=symmetric)
        elif M is not None:
            self.M = M
        elif pc == "jacobi":
            self.M = jacobi_from_blocks(ops, n_dofs, self.free_mask)
        # the constrained operator, on every path (the modal path applies
        # it on the dense one too)
        self.matvec = _sum_of_blocks(ops, self.free_mask)
        if extra_matvec is not None:
            self.matvec = _with_extra(self.matvec, extra_matvec,
                                      self.free_mask)

    @property
    def matvecT(self):
        """The transposed constrained operator: the forward one when
        symmetric, else the fused operator on the transposed blocks."""
        if self.symmetric:
            return self.matvec
        if self._matvecT is None:
            mvT = _sum_of_blocks(
                [(Ae.permute(1, 0, 2).contiguous(), sp)
                 for Ae, sp in self.ops], self.free_mask)
            if self.extra_matvec is not None:
                mvT = _with_extra(mvT, _transpose(self.extra_matvec, self.n,
                                                  self.free_mask),
                                  self.free_mask)
            self._matvecT = mvT
        return self._matvecT

    def lift(self, b, bc_vals):
        """The RHS for the constrained system whose solution carries the
        BC values: free*(b - A g) + g with g = (1-free)*bc_vals, A the raw
        (unconstrained) operator (assembly/bc.py::lift_rhs)."""
        raw = _sum_of_blocks(self.ops, torch.ones_like(self.free_mask))
        if self.extra_matvec is not None:
            raw = _with_extra(raw, self.extra_matvec,
                              torch.ones_like(self.free_mask))
        return lift_rhs(raw, b, self.free_mask, bc_vals)

    def _krylov(self, op, b, x0):
        if self.method == "cg" and self.symmetric:
            return cg_solve(op, b, x0=x0, M=self.M, tol=self.tol,
                            maxiter=self.maxiter)
        return gmres_solve(op, b, x0=x0, M=self.M, tol=self.tol,
                           maxiter=max(2, self.maxiter // 50))

    def solve(self, b, x0=None):
        if self._dense is not None:
            return self._dense.solve(b)
        x, self.last_info = self._krylov(self.matvec, b, x0)
        return x

    def solve_transpose(self, b, x0=None):
        """The adjoint solve: the forward one when symmetric."""
        if self._dense is not None:
            return self._dense.solve_transpose(b)
        x, self.last_info = self._krylov(self.matvecT, b, x0)
        return x
