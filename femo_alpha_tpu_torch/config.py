"""Global configuration (port of femo_alpha_tpu/config.py).

A dataclass of defaults that the solvers consult; models take explicit
keyword arguments. The port solves in f64 (native on the H100), so the
floating dtype is torch.float64 and no environment variable changes it.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Config:
    # default floating dtype for FEM tensors
    dtype: object = torch.float64
    # index dtype for dofmaps/connectivity (the fused operator's tables)
    index_dtype: object = torch.int32
    # print solver reports (parity with FEA.REPORT)
    report: bool = False
    # fail loudly on nonconvergence (newton_solve raises)
    error_on_nonconvergence: bool = True


config = Config()


def fdtype():
    """Default floating dtype."""
    return config.dtype


def idtype():
    """Default index dtype."""
    return config.index_dtype
