"""The transient Reissner-Mindlin shell (port of
femo_alpha_tpu/models/dynamic_rm_shell)."""

from .operations import (
    StateOperation,
    TotalStrainEnergyOperation,
    VolumeOperation,
)
from .plate_sim import PlateSim

__all__ = [
    "PlateSim",
    "StateOperation",
    "TotalStrainEnergyOperation",
    "VolumeOperation",
]
