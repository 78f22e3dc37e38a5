"""Dense assembly helpers (port of the parts of
femo_alpha_tpu/solvers/direct.py that the modal path needs).

The port's dense solve is LinearSolver(method="dense"), an f64 Cholesky of
the constrained matrix; DenseSolver and solve_spd_small are not ported.
"""

from __future__ import annotations

import torch


def dense_from_elements(Ae, dofmap, n_dofs):
    """Scatter cell-major element matrices Ae (nc, nd, nd) with a (nc, nd)
    dofmap (array or tensor) into a dense (n, n) matrix on Ae's device."""
    nc, nd, _ = Ae.shape
    dm = torch.as_tensor(dofmap, dtype=torch.int64, device=Ae.device)
    rows = dm[:, :, None].expand(nc, nd, nd).reshape(-1)
    cols = dm[:, None, :].expand(nc, nd, nd).reshape(-1)
    A = Ae.new_zeros((n_dofs, n_dofs))
    A.index_put_((rows, cols), Ae.reshape(-1), accumulate=True)
    return A


def apply_bc_dense(A, free_mask):
    """Symmetric BC elimination on a dense matrix: identity rows and
    columns at the constrained dofs."""
    f = free_mask
    return A * f[:, None] * f[None, :] + torch.diag(1.0 - f)
