"""Gradient-based optimization (port of femo_alpha_tpu/opt): scipy SLSQP
over autograd gradients."""

from .problem import SLSQP, OptimizationProblem

__all__ = ["OptimizationProblem", "SLSQP"]
