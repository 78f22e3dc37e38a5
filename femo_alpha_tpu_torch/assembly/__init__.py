"""Assembly: cell forms, BCs, affine design operator and the Hopper
kernels (K1 cell_matvec_T, the fused constrained_matvec_T, K2
affine_combine) and the CSR pattern."""

from .assemble import (
    FemForm,
    assemble_residual,
    assemble_scalar,
    cell_matvec,
    element_matrices,
    gather_dofs,
    make_constrained_matvec_T,
    make_jvp_matvec,
    make_matvec,
    make_matvec_T,
    scatter_add,
    transpose_cellwise,
    transpose_cellwise_inv,
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
    "make_matvec",
    "scatter_add",
    "gather_dofs",
    "cell_matvec",
    "make_jvp_matvec",
    "transpose_cellwise",
    "transpose_cellwise_inv",
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
