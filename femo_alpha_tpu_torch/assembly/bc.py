"""Strong Dirichlet BC handling by symmetric masking.

Port of femo_alpha_tpu/assembly/bc.py. The constrained operator
B(v) = free*(A(free*v)) + bc*v keeps the SPD structure, so CG applies, and
it is its own transpose: the adjoint solve uses the same operator.
"""

from __future__ import annotations

import numpy as np
import torch


class DirichletBC:
    """dofs: global dof indices (component-expanded); values: same length
    or scalar."""

    def __init__(self, dofs, values=0.0):
        self.dofs = np.asarray(dofs, dtype=np.int32)
        values = np.asarray(values, dtype=np.float64)
        if values.ndim == 0:
            values = np.full(len(self.dofs), float(values))
        self.values = values


def combine_bcs(n_dofs, bcs, dtype=torch.float64, device=None):
    """Return (free_mask (n,), bc_vals (n,)) as tensors."""
    free = np.ones(n_dofs, dtype=np.float64)
    vals = np.zeros(n_dofs, dtype=np.float64)
    for bc in bcs or []:
        free[bc.dofs] = 0.0
        vals[bc.dofs] = bc.values
    return (torch.as_tensor(free, dtype=dtype, device=device),
            torch.as_tensor(vals, dtype=dtype, device=device))


def constrain_matvec(matvec, free_mask):
    """B(v) = free*(A(free*v)) + (1-free)*v — identity on BC dofs."""

    def op(v):
        return free_mask * matvec(free_mask * v) + (1.0 - free_mask) * v

    return op


def lift_rhs(matvec, b, free_mask, bc_vals):
    """RHS for the constrained system so the solution carries bc values:
    c = free*(b - A(bc_vals_extended)) + bc*bc_vals."""
    g = (1.0 - free_mask) * bc_vals
    return free_mask * (b - matvec(g)) + g


def constrain_residual(residual, u, free_mask, bc_vals):
    """Residual with BC rows replaced by (u - u_bc)."""
    return free_mask * residual + (1.0 - free_mask) * (u - bc_vals)
