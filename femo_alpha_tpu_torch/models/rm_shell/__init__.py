"""Reissner-Mindlin shell model (port of femo_alpha_tpu/models/rm_shell)."""

from .model import RMShellModel
from .pde import RMShellPDE

__all__ = ["RMShellModel", "RMShellPDE"]
