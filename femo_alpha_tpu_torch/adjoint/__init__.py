"""Implicit-function adjoint and the finite-difference check (port of
femo_alpha_tpu/adjoint/implicit.py and check.py)."""

from .check import check_totals
from .implicit import ImplicitPDE

__all__ = ["ImplicitPDE", "check_totals"]
