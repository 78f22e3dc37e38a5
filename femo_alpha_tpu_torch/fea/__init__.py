"""Problem registry and model facade (port of femo_alpha_tpu/fea)."""

from .fea import FEA
from .model import FEAModel, VariableGroup

__all__ = ["FEA", "FEAModel", "VariableGroup"]
