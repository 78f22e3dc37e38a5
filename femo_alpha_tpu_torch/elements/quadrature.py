"""Quadrature rules on reference cells (numpy, setup-time only).

Reference cells:
  interval : [0, 1]
  triangle : vertices (0,0), (1,0), (0,1)
  quad     : vertices (0,0), (1,0), (1,1), (0,1)  (CCW)

Reduced rules mirror the shear-locking mitigation knob of the reference
(linear_shell_model.py:88-103 uses reduced-degree measures for in-plane vs
shear energy).
"""

from __future__ import annotations

import numpy as np


def _gauss_01(n: int):
    """n-point Gauss-Legendre on [0,1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def _npoints_for_degree(degree: int) -> int:
    # n-point Gauss integrates degree 2n-1 exactly
    return max(1, (degree + 2) // 2)


def quadrature_rule(cell_type: str, degree: int):
    """Return (points (nq, rdim), weights (nq,)) integrating polynomials of
    `degree` exactly on the reference cell (triangle rules are exact via the
    Duffy transform with degree bumped on the collapsed axis)."""
    if cell_type == "interval":
        p, w = _gauss_01(_npoints_for_degree(degree))
        return p.reshape(-1, 1), w
    if cell_type == "quad":
        p, w = _gauss_01(_npoints_for_degree(degree))
        X, Y = np.meshgrid(p, p, indexing="ij")
        W = np.outer(w, w)
        return np.stack([X.ravel(), Y.ravel()], axis=1), W.ravel()
    if cell_type == "triangle":
        # Duffy: (u,v) in [0,1]^2 -> (x,y) = (u, v*(1-u)), |J| = 1-u.
        # Exactness: integrand degree d in (x,y) becomes degree <= 2d+1 in u
        # after multiplying by (1-u); use degree+1 points per axis (cheap,
        # setup-time only).
        n = _npoints_for_degree(2 * degree + 1)
        p, w = _gauss_01(n)
        U, V = np.meshgrid(p, p, indexing="ij")
        WU, WV = np.meshgrid(w, w, indexing="ij")
        x = U
        y = V * (1.0 - U)
        wt = WU * WV * (1.0 - U)
        return np.stack([x.ravel(), y.ravel()], axis=1), wt.ravel()
    raise ValueError(f"unknown cell type {cell_type!r}")
