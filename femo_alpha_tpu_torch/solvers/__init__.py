"""Krylov solver, geometric multigrid and the linear-solver facade."""

from .krylov import cg_solve
from .linear import LinearSolver
from .multigrid import GeometricMG

__all__ = ["cg_solve", "LinearSolver", "GeometricMG"]
