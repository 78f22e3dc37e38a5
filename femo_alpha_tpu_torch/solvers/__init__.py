"""Krylov solvers, Newton, preconditioners, geometric multigrid, the band
Cholesky, the aggregation AMG, eigensolvers and the linear-solver facade."""

from .amg import AggregationAMG, AMGPrecondFactory
from .band import BandCholPrecond, band_precond_factory
from .direct import DenseSolver, dense_from_elements
from .eigen import dense_generalized_eigh, lobpcg
from .krylov import cg_solve, gmres_solve
from .linear import LinearSolver
from .multigrid import GeometricMG, make_space_transfer
from .newton import newton_solve
from .precond import (
    block_jacobi_preconditioner,
    jacobi_preconditioner,
    mixed_block_jacobi,
)

__all__ = ["AggregationAMG", "AMGPrecondFactory", "BandCholPrecond",
           "band_precond_factory", "DenseSolver", "dense_from_elements",
           "dense_generalized_eigh", "lobpcg", "cg_solve", "gmres_solve",
           "LinearSolver", "GeometricMG", "make_space_transfer",
           "newton_solve", "jacobi_preconditioner", "mixed_block_jacobi",
           "block_jacobi_preconditioner"]
