"""Models (port of femo_alpha_tpu/models): the RM shell, Poisson (linear
and nonlinear), plane elasticity and the Hermite beam."""

from .beam import EulerBernoulliBeamModel
from .elasticity import ElasticityModel
from .poisson import NonlinearPoissonModel, PoissonModel
from .rm_shell import (
    CompositeCLT,
    ForceReshapingModel,
    RMShellModel,
    RMShellPDE,
)

__all__ = ["EulerBernoulliBeamModel", "RMShellModel", "RMShellPDE",
           "CompositeCLT", "ForceReshapingModel", "NonlinearPoissonModel",
           "PoissonModel", "ElasticityModel"]
