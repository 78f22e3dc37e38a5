"""Geometry mapping helpers used inside cell kernels (torch, one cell at a
time; the assembly vmaps over cells).

Port of femo_alpha_tpu/assembly/geometry.py: the cell Jacobian, 2x2
determinants and inverses, the surface measure, and `map_gradients`
(physical basis gradients and the quadrature measure for square
Jacobians), which fea/utils.py's projections and norms use.
"""

from __future__ import annotations

import torch


def _table(a, like):
    """A static numpy table as a tensor of `like`'s dtype and device (made
    per call: these helpers run inside torch.func transforms)."""
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def cell_jacobian(x_cell, gdphi):
    """J[g, r] = d x_g / d xi_r at one quadrature point.

    x_cell: (nv, gdim) cell vertex coords; gdphi: (nv, rdim) geometry basis
    reference gradients at the point."""
    return torch.einsum("ag,ar->gr", x_cell, _table(gdphi, x_cell))


def det_2x2(J):
    return J[0, 0] * J[1, 1] - J[0, 1] * J[1, 0]


def inv_2x2(J):
    d = det_2x2(J)
    return torch.stack([torch.stack([J[1, 1], -J[0, 1]]),
                        torch.stack([-J[1, 0], J[0, 0]])]) / d


def det_metric(J):
    """Surface measure sqrt(det(J^T J)) for gdim x rdim Jacobians (shells:
    3x2). Equals |detJ| when square."""
    G = J.T @ J
    if G.shape == (1, 1):
        return torch.sqrt(G[0, 0])
    return torch.sqrt(torch.clamp(det_2x2(G), min=0.0))


# ------------------------- batched-over-quadrature helpers (inside vmap) ----
def jacobians(x_cell, geom_dphi):
    """All-quadrature-point Jacobians: (nq, gdim, rdim).

    x_cell: (nv, gdim); geom_dphi: (nq, nv, rdim) table."""
    return torch.einsum("ag,qar->qgr", x_cell, _table(geom_dphi, x_cell))


def det_2x2_b(J):
    return J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]


def inv_2x2_b(J):
    d = det_2x2_b(J)
    inv = torch.stack(
        [torch.stack([J[..., 1, 1], -J[..., 0, 1]], dim=-1),
         torch.stack([-J[..., 1, 0], J[..., 0, 0]], dim=-1)],
        dim=-2)
    return inv / d[..., None, None]


def map_gradients(x_cell, tab):
    """Physical basis gradients + quadrature measure for square Jacobians.

    tab: elements.ElementTables. Returns (dphi_x (nq, nd, gdim), wdet (nq,))
    where wdet = w_q * |detJ_q|. Handles rdim == gdim in {1, 2}."""
    J = jacobians(x_cell, tab.geom_dphi)  # (nq, g, r)
    dphi = _table(tab.dphi, x_cell)  # (nq, nd, r)
    w = _table(tab.weights, x_cell)
    if J.shape[-1] == 1:
        detJ = J[:, 0, 0]
        return dphi / detJ[:, None, None], w * torch.abs(detJ)
    detJ = det_2x2_b(J)
    dphi_x = torch.einsum("qar,qrg->qag", dphi, inv_2x2_b(J))
    return dphi_x, w * torch.abs(detJ)
