"""Constitutive (CLT) models for Reissner-Mindlin shells (port of
femo_alpha_tpu/models/rm_shell/material.py): the isotropic single-layer
A/B/D/A_s matrices on the MID or BOT reference plane, pointwise and
broadcast over quadrature points, so autograd through them yields the
thickness and material partials; and the per-cell composite laminate data
(CompositeCLT), host numpy in f64, which rides the cell axis of the energy
kernels as FemForm cell constants."""

from __future__ import annotations

import numpy as np
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


class CompositeCLT:
    """Per-cell laminate CLT data: A, B, D (nc, 3, 3) and A_s (nc, 2, 2),
    f64 numpy, in the mesh's FE cell order. When a model carries one, the
    elastic energy uses these tensors in place of the isotropic
    single-layer CLT; drilling, mass, stresses and the DG1 projection stay
    isotropic in (E, nu, h)."""

    def __init__(self, A, B, D, As):
        self.A = np.asarray(A, dtype=np.float64)
        self.B = np.asarray(B, dtype=np.float64)
        self.D = np.asarray(D, dtype=np.float64)
        self.As = np.asarray(As, dtype=np.float64)
        nc = self.A.shape[0]
        assert self.A.shape == (nc, 3, 3) and self.B.shape == (nc, 3, 3)
        assert self.D.shape == (nc, 3, 3) and self.As.shape == (nc, 2, 2)

    @classmethod
    def from_layup(cls, n_cells, E_layers, nu_layers, z_interfaces):
        """Classical lamination theory for a stack of isotropic plies:
        E_layers, nu_layers (n_plies,) per-ply moduli, z_interfaces
        (n_plies + 1,) through-thickness interface coordinates (midplane at
        0). The same laminate in every cell (per-cell layups are built by
        stacking calls). A = sum C dz, B = sum C z dz, D = sum C z^2 dz,
        A_s = sum k G dz I2."""
        E = np.asarray(E_layers, dtype=np.float64)
        nu = np.asarray(nu_layers, dtype=np.float64)
        z = np.asarray(z_interfaces, dtype=np.float64)
        A = np.zeros((3, 3))
        B = np.zeros((3, 3))
        D = np.zeros((3, 3))
        As = np.zeros((2, 2))
        for k in range(len(E)):
            C = plane_stress_C(torch.as_tensor(E[k]),
                               torch.as_tensor(nu[k])).numpy()
            z0, z1 = z[k], z[k + 1]
            A += C * (z1 - z0)
            B += C * (z1 ** 2 - z0 ** 2) / 2.0
            D += C * (z1 ** 3 - z0 ** 3) / 3.0
            G = E[k] / (2.0 * (1.0 + nu[k]))
            As += SHEAR_CORRECTION * G * (z1 - z0) * np.eye(2)

        def tile(M):
            return np.broadcast_to(M, (n_cells,) + M.shape).copy()

        return cls(tile(A), tile(B), tile(D), tile(As))


def single_layer_clt(E, nu, h, bot=False):
    """Isotropic single-layer CLT (A, B, D, A_s) from pointwise E, nu, h.
    MID reference plane (default): A = hC, B = 0, D = h^3/12 C; BOT:
    A = hC, B = -h^2/2 C, D = h^3/3 C. A_s = k G h I2."""
    C = plane_stress_C(E, nu)
    G = E / (2.0 * (1.0 + nu))
    A = h[..., None, None] * C
    if bot:
        B = (-(h ** 2) / 2.0)[..., None, None] * C
        D = (h ** 3 / 3.0)[..., None, None] * C
    else:
        B = torch.zeros_like(C)
        D = (h ** 3 / 12.0)[..., None, None] * C
    eye2 = torch.eye(2, dtype=C.dtype, device=C.device)
    As = (SHEAR_CORRECTION * G * h)[..., None, None] * eye2
    return A, B, D, As
