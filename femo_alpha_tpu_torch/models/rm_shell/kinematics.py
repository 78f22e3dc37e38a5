"""Shell kinematics, batched over quadrature points (one cell at a time;
the assembly vmaps over cells).

Port of femo_alpha_tpu/models/rm_shell/kinematics.py:

- the surface Jacobian Jg = dx/dxi is (3, 2); physical (tangent-plane)
  gradients use the pseudo-inverse Pi = (Jg^T Jg)^{-1} Jg^T
- the mesh-motion field uhat deforms the configuration: F = I3 + grad(uhat),
  gradx(f) = grad(f) @ inv(F), J = det(F)
- the local orthonormal frame is E2 = unit(a0 x a1), E0 = unit(a0),
  E1 = E2 x E0, from the reference configuration
"""

from __future__ import annotations

import torch


def _norm(v, dim=-1):
    return torch.sqrt(torch.sum(v * v, dim=dim))


def cross(a, b, dim=-1):
    """Cross product along `dim` (written out: forward-mode AD friendly)."""
    a0, a1, a2 = a.unbind(dim)
    b0, b1, b2 = b.unbind(dim)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=dim)


def surface_geometry(x_cell, geom_dphi):
    """Per-quadrature-point surface geometry.

    x_cell (nv, 3); geom_dphi (nq, nv, 2) table.
    Returns dict with Jg (nq,3,2), dA (nq,), frame E0/E1/E2 (nq,3),
    Pi (nq,2,3) = d(xi)/dx pseudo-inverse."""
    Jg = torch.einsum("ag,qar->qgr", x_cell, geom_dphi)
    a0, a1 = Jg[:, :, 0], Jg[:, :, 1]
    nvec = cross(a0, a1)
    dA = _norm(nvec)
    E2 = nvec / dA[:, None]
    E0 = a0 / _norm(a0)[:, None]
    E1 = cross(E2, E0)
    G = torch.einsum("qgr,qgs->qrs", Jg, Jg)  # metric (nq,2,2)
    detG = G[:, 0, 0] * G[:, 1, 1] - G[:, 0, 1] * G[:, 1, 0]
    Gi = torch.stack(
        [torch.stack([G[:, 1, 1], -G[:, 0, 1]], dim=-1),
         torch.stack([-G[:, 1, 0], G[:, 0, 0]], dim=-1)],
        dim=-2,
    ) / detG[:, None, None]
    Pi = torch.einsum("qrs,qgs->qrg", Gi, Jg)  # (nq, 2, 3)
    return dict(Jg=Jg, dA=dA, E0=E0, E1=E1, E2=E2, Pi=Pi)


def phys_grad_table(dphi, Pi):
    """Physical-gradient basis table: (nq, nd, 3) from reference gradients
    dphi (nq, nd, 2) and Pi (nq, 2, 3)."""
    return torch.einsum("qar,qrg->qag", dphi, Pi)


def det_3x3(F):
    return (
        F[..., 0, 0] * (F[..., 1, 1] * F[..., 2, 2]
                        - F[..., 1, 2] * F[..., 2, 1])
        - F[..., 0, 1] * (F[..., 1, 0] * F[..., 2, 2]
                          - F[..., 1, 2] * F[..., 2, 0])
        + F[..., 0, 2] * (F[..., 1, 0] * F[..., 2, 1]
                          - F[..., 1, 1] * F[..., 2, 0])
    )


def inv_3x3(F):
    d = det_3x3(F)
    c00 = F[..., 1, 1] * F[..., 2, 2] - F[..., 1, 2] * F[..., 2, 1]
    c01 = F[..., 0, 2] * F[..., 2, 1] - F[..., 0, 1] * F[..., 2, 2]
    c02 = F[..., 0, 1] * F[..., 1, 2] - F[..., 0, 2] * F[..., 1, 1]
    c10 = F[..., 1, 2] * F[..., 2, 0] - F[..., 1, 0] * F[..., 2, 2]
    c11 = F[..., 0, 0] * F[..., 2, 2] - F[..., 0, 2] * F[..., 2, 0]
    c12 = F[..., 0, 2] * F[..., 1, 0] - F[..., 0, 0] * F[..., 1, 2]
    c20 = F[..., 1, 0] * F[..., 2, 1] - F[..., 1, 1] * F[..., 2, 0]
    c21 = F[..., 0, 1] * F[..., 2, 0] - F[..., 0, 0] * F[..., 2, 1]
    c22 = F[..., 0, 0] * F[..., 1, 1] - F[..., 0, 1] * F[..., 1, 0]
    inv = torch.stack(
        [torch.stack([c00, c01, c02], dim=-1),
         torch.stack([c10, c11, c12], dim=-1),
         torch.stack([c20, c21, c22], dim=-1)],
        dim=-2,
    )
    return inv / d[..., None, None]


def deformation(uhat_nodes, dphi1_x):
    """F = I + grad(uhat), its inverse and determinant, per quadrature point.

    uhat_nodes (nv, 3); dphi1_x (nq, nv, 3) physical-gradient table of the
    geometry element. Returns (F (nq,3,3), Finv, detF)."""
    Guh = torch.einsum("ai,qag->qig", uhat_nodes, dphi1_x)
    eye = torch.eye(3, dtype=Guh.dtype, device=Guh.device)
    F = eye[None] + Guh
    return F, inv_3x3(F), det_3x3(F)


def cell_diameter(x_cell):
    """Max vertex-pair distance (UFL CellDiameter parity)."""
    d = x_cell[:, None, :] - x_cell[None, :, :]
    return torch.sqrt(torch.amax(torch.sum(d * d, dim=-1)))


def sym2(M):
    """Symmetrize a (..., 2, 2) tensor."""
    return 0.5 * (M + M.transpose(-1, -2))


def voigt2d(M):
    """(..., 2, 2) symmetric strain tensor -> (..., 3) Voigt (off-diagonal
    doubled)."""
    return torch.stack([M[..., 0, 0], M[..., 1, 1], 2.0 * M[..., 0, 1]],
                       dim=-1)
