"""Krylov solvers, Newton, preconditioners, geometric multigrid, the
aggregation AMG and the linear-solver facade."""

from .amg import AggregationAMG, AMGPrecondFactory
from .direct import DenseSolver, dense_from_elements
from .krylov import cg_solve, gmres_solve
from .linear import LinearSolver
from .multigrid import GeometricMG
from .newton import newton_solve
from .precond import (
    block_jacobi_preconditioner,
    jacobi_preconditioner,
    mixed_block_jacobi,
)

__all__ = ["AggregationAMG", "AMGPrecondFactory", "DenseSolver",
           "dense_from_elements", "cg_solve", "gmres_solve",
           "LinearSolver", "GeometricMG", "newton_solve",
           "jacobi_preconditioner", "mixed_block_jacobi",
           "block_jacobi_preconditioner"]
