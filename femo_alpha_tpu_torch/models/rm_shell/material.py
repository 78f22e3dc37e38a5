"""Constitutive (CLT) models for Reissner-Mindlin shells: the isotropic
single-layer A/B/D/A_s matrices (port of
femo_alpha_tpu/models/rm_shell/material.py; the composite per-cell laminate
data is not ported yet, ROADMAP.md Queue 1). Pointwise, broadcast over
quadrature points, so autograd through them yields the thickness and
material partials."""

from __future__ import annotations

import torch

SHEAR_CORRECTION = 0.833  # Nastran shear correction


def plane_stress_C(E, nu):
    """(..., 3, 3) plane-stress stiffness from pointwise E, nu."""
    z = torch.zeros_like(E)
    fac = E / (1.0 - nu * nu)
    row0 = torch.stack([fac, fac * nu, z], dim=-1)
    row1 = torch.stack([fac * nu, fac, z], dim=-1)
    row2 = torch.stack([z, z, fac * 0.5 * (1.0 - nu)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def single_layer_clt(E, nu, h):
    """Isotropic single-layer CLT (A, B, D, A_s) from pointwise E, nu, h on
    the MID reference plane: A = hC, B = 0, D = h^3/12 C, A_s = k G h I2."""
    C = plane_stress_C(E, nu)
    G = E / (2.0 * (1.0 + nu))
    A = h[..., None, None] * C
    B = torch.zeros_like(C)
    D = (h ** 3 / 12.0)[..., None, None] * C
    eye2 = torch.eye(2, dtype=C.dtype, device=C.device)
    As = (SHEAR_CORRECTION * G * h)[..., None, None] * eye2
    return A, B, D, As
