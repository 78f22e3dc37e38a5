"""Point evaluation: the interpolation row of a space at arbitrary physical
points (host-side setup, numpy).

Copy of femo_alpha_tpu/spaces/pointeval.py. For surface meshes the
pull-back solves the 2D least-squares parametric inverse with a few Newton
iterations (exact for affine triangles, fast converging for bilinear
quads).
"""

from __future__ import annotations

import numpy as np

from ..elements import reference_element


def _pull_back(elem_geom, x_cell, x, rdim, iters=15):
    """Newton least-squares inverse of the geometry map, numpy."""
    xi = np.full(rdim, 0.5)
    if elem_geom.cell_type == "triangle":
        xi = np.array([1 / 3, 1 / 3])
    for _ in range(iters):
        phi = elem_geom.tabulate(xi[None, :], 0)[0]  # (nv,)
        dphi = elem_geom.tabulate(xi[None, :], 1)[0]  # (nv, rdim)
        r = phi @ x_cell - x  # (gdim,)
        J = np.einsum("ar,ag->gr", dphi, x_cell)  # (gdim, rdim)
        dxi = np.linalg.lstsq(J, r, rcond=None)[0]
        xi = xi - dxi
        if np.linalg.norm(dxi) < 1e-14:
            break
    return xi


def point_eval_rows(space, points):
    """For each point: (cell_id, dof_indices (nd,), weights (nd,)) of the
    scalar-space interpolation. Vector spaces: apply per component using the
    scalar dofmap (dof*vs + comp)."""
    mesh = space.mesh
    points = np.atleast_2d(np.asarray(points, dtype=np.float64))
    mids = mesh.cell_midpoints()
    geom = reference_element("P", mesh.cell_type, 1)
    elem = space.element
    rows = []
    for x in points:
        # candidate cells by midpoint distance (robust enough for setup)
        cand = np.argsort(np.linalg.norm(mids - x[None, :], axis=1))[:8]
        best_c, best_xi, best_err = None, None, np.inf
        for c in cand:
            xc = mesh.coords[mesh.conn[c]]
            xi = _pull_back(geom, xc, x, mesh.rdim)
            tol = 1e-8
            if mesh.cell_type == "triangle":
                inside = (
                    xi[0] >= -tol and xi[1] >= -tol and xi.sum() <= 1 + tol
                )
            elif mesh.cell_type == "quad":
                inside = np.all(xi >= -tol) and np.all(xi <= 1 + tol)
            else:
                inside = -tol <= xi[0] <= 1 + tol
            err = np.linalg.norm(geom.tabulate(xi[None], 0)[0] @ xc - x)
            if not inside:
                err += 1.0  # prefer containing cells
            if err < best_err:
                best_c, best_xi, best_err = c, xi, err
            if inside and err < 1e-8:
                break
        c, xi = best_c, best_xi
        w = elem.tabulate(np.asarray(xi)[None, :], 0)[0]  # (nd,)
        rows.append((int(c), space.scalar_dofmap[c].copy(), w))
    return rows
