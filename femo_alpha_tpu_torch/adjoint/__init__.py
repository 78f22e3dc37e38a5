"""Implicit-function adjoint (port of femo_alpha_tpu/adjoint/implicit.py)."""

from .implicit import ImplicitPDE

__all__ = ["ImplicitPDE"]
