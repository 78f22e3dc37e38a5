"""Reissner-Mindlin shell model (port of femo_alpha_tpu/models/rm_shell)."""

from .material import CompositeCLT
from .model import ForceReshapingModel, RMShellModel
from .pde import RMShellPDE

__all__ = ["CompositeCLT", "ForceReshapingModel", "RMShellModel",
           "RMShellPDE"]
