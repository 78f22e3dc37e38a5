"""Function spaces (port of femo_alpha_tpu/spaces)."""

from .space import FunctionSpace, MixedSpace, locate_dofs_geometric

__all__ = ["FunctionSpace", "MixedSpace", "locate_dofs_geometric"]
