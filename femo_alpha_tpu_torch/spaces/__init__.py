"""Function spaces (port of femo_alpha_tpu/spaces)."""

from .space import Function, FunctionSpace, MixedSpace, locate_dofs_geometric

__all__ = ["Function", "FunctionSpace", "MixedSpace", "locate_dofs_geometric"]
