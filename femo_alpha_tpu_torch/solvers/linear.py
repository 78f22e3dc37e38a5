"""LinearSolver: one object per linearized system — preconditioned CG on
the strong-BC-constrained, lane-major matrix-free operator (the fused
constrained_matvec_T kernel on the card).

Port of the CG + external-preconditioner path of
femo_alpha_tpu/solvers/linear.py::LinearSolver (op0_layout='lane'). The
constrained operator B = f*A*f + (1-f)*I is symmetric, so the transposed
(adjoint) solve reuses the forward matvec. The dense, GMRES, Jacobi and
facet-block paths are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import torch

from ..assembly.assemble import make_constrained_matvec_T
from .krylov import cg_solve


class LinearSolver:
    """Solve A x = b with strong-BC masking.

    ops: [(Ae (nd, nd, nc) lane-major, space)] — one cell block; M: the
    preconditioner application v -> M^{-1} v (e.g. an MG V-cycle)."""

    def __init__(self, ops, n_dofs, free_mask=None, tol=1e-12, maxiter=None,
                 M=None):
        if len(ops) != 1:
            raise NotImplementedError(
                "LinearSolver: facet blocks are not ported to "
                "femo_alpha_tpu_torch yet (ROADMAP.md, Queue 1)")
        Ae0, sp0 = ops[0]
        self.ops = ops
        self.n = n_dofs
        self.tol = tol
        self.maxiter = maxiter or min(max(500, 10 * n_dofs), 200_000)
        self.free_mask = (torch.ones(n_dofs, dtype=Ae0.dtype,
                                     device=Ae0.device)
                          if free_mask is None else free_mask)
        self.matvec = make_constrained_matvec_T(Ae0, sp0, self.free_mask)
        self.M = M
        self.last_info = None

    def solve(self, b):
        x, self.last_info = cg_solve(self.matvec, b, M=self.M, tol=self.tol,
                                     maxiter=self.maxiter)
        return x

    def solve_transpose(self, b):
        """The constrained operator is symmetric: same matvec as `solve`."""
        return self.solve(b)
