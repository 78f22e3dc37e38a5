"""Assembly: cell forms, BCs, affine design operator and the Hopper
kernels (K1 cell_matvec_T, the fused constrained_matvec_T, K2
affine_combine) and the CSR pattern."""

from .assemble import (
    FemForm,
    assemble_residual,
    assemble_scalar,
    element_matrices,
    make_constrained_matvec_T,
    make_matvec_T,
)
from .bc import DirichletBC, combine_bcs, constrain_matvec, lift_rhs
from .cuda_kernels import affine_combine, cell_matvec_T, constrained_matvec_T
from .geometry import cell_jacobian, det_2x2, det_metric, inv_2x2
from .sparse import CSRPattern

__all__ = [
    "cell_jacobian",
    "det_metric",
    "inv_2x2",
    "det_2x2",
    "FemForm",
    "assemble_residual",
    "assemble_scalar",
    "element_matrices",
    "make_constrained_matvec_T",
    "make_matvec_T",
    "DirichletBC",
    "combine_bcs",
    "constrain_matvec",
    "lift_rhs",
    "affine_combine",
    "cell_matvec_T",
    "constrained_matvec_T",
    "CSRPattern",
]
