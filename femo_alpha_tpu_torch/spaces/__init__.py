"""Function spaces (port of femo_alpha_tpu/spaces)."""

from .space import (
    CellRange,
    Function,
    FunctionSpace,
    MixedSpace,
    locate_dofs_geometric,
)

__all__ = ["CellRange", "Function", "FunctionSpace", "MixedSpace",
           "locate_dofs_geometric"]
