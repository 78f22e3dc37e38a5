"""FEA utility helpers: error norms, L2 projection, mesh motion, surface
area, point loads and the vertex-to-dof maps.

Port of femo_alpha_tpu/fea/utils.py (the reference's helpers of
linear_shell_fenicsx/utils.py and utils_dolfinx.py). The mass solves are
CG (solvers/krylov.py::cg_solve) over the fused constrained operator with
an all-ones mask (assembly/assemble.py::make_constrained_matvec_T), the
kernel every solve of the port applies on the card. Point location runs on
the host (spaces/pointeval.py). Results are f64 tensors on the device of
a tensor input, else on `device` (the CUDA card unless named).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from ..assembly.assemble import make_constrained_matvec_T
from ..assembly.geometry import map_gradients
from ..device import resolve_device, tensor_on
from ..elements import tabulate
from ..solvers.krylov import cg_solve
from ..spaces import FunctionSpace
from ..spaces.pointeval import point_eval_rows


def _device_of(v, device):
    return v.device if isinstance(v, torch.Tensor) else \
        resolve_device(device)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _tables(space, quad_degree):
    return tabulate(space.family, space.mesh.cell_type, space.degree,
                    quad_degree=quad_degree or 2 * space.degree + 2)


def _cell_coords(mesh, device):
    return torch.as_tensor(mesh.cell_coords(), dtype=torch.float64,
                           device=device)


def _at_points(fn, tab, mesh):
    """fn(x (1, gdim)) evaluated at every physical quadrature point:
    (nc, nq) numpy."""
    xq = np.einsum("qa,cag->cqg", tab.geom_phi, mesh.cell_coords())
    return np.apply_along_axis(lambda x: fn(x.reshape(1, -1))[0], -1, xq)


def _mass_solve(m_c, space, b, tol, maxiter):
    """CG on the mass matrix of cell blocks m_c (nc, nd, nd), through the
    fused operator with every dof free."""
    ones = torch.ones(space.n_dofs, dtype=b.dtype, device=b.device)
    mv = make_constrained_matvec_T(m_c.permute(1, 2, 0).contiguous(), space,
                                   ones)
    x, _ = cg_solve(mv, b, tol=tol, maxiter=maxiter)
    return x


def errorNorm(space: FunctionSpace, u, exact_fn, norm="L2", quad_degree=None,
              device=None):
    """||u_h - u_exact||_L2 for scalar Lagrange spaces on flat meshes
    (parity with errorNorm, utils_dolfinx.py:244-256). Returns a float."""
    dev = _device_of(u, device)
    tab = _tables(space, quad_degree)
    phi = torch.as_tensor(tab.phi, device=dev)
    ue = torch.as_tensor(_at_points(exact_fn, tab, space.mesh),
                         dtype=torch.float64, device=dev)  # (nc, nq)

    def cell_err(u_cell, x_cell, ue_cell):
        _, wdet = map_gradients(x_cell, tab)
        return torch.sum(wdet * (phi @ u_cell - ue_cell) ** 2)

    uc = space.gather(tensor_on(u, dev, "errorNorm"))
    vals = vmap(cell_err)(uc, _cell_coords(space.mesh, dev), ue)
    return float(torch.sqrt(torch.sum(vals)))


def project(space: FunctionSpace, fn_or_values, lump_mass=False,
            quad_degree=None, device=None):
    """L2 projection of per-quadrature-point values (nc, nq) or of a
    coordinate callable into `space` (parity with project,
    utils_dolfinx.py / linear_shell_fenicsx/utils.py:52-86), with optional
    mass lumping; the consistent mass solve is CG to 1e-12."""
    dev = _device_of(fn_or_values, device)
    tab = _tables(space, quad_degree)
    phi = torch.as_tensor(tab.phi, device=dev)
    if callable(fn_or_values):
        vals = _at_points(fn_or_values, tab, space.mesh)
    else:
        vals = fn_or_values
    vals = tensor_on(vals, dev, "project")

    def cell_rhs(x_cell, v_cell):
        _, wdet = map_gradients(x_cell, tab)
        b = torch.einsum("qa,q,q->a", phi, v_cell, wdet)
        m = torch.einsum("qa,qb,q->ab", phi, phi, wdet)
        return b, m

    b_c, m_c = vmap(cell_rhs)(_cell_coords(space.mesh, dev), vals)
    b = space.scatter_add(b_c)
    if lump_mass:
        return b / space.scatter_add(torch.sum(m_c, dim=2))
    return _mass_solve(m_c, space, b, 1e-12, 10 * space.n_dofs)


def move(mesh, displacement):
    """A NEW mesh whose coordinates are moved by a nodal displacement
    (n_nodes, gdim) (parity with move, utils_dolfinx.py:533-553; the
    shape-derivative path moves the mesh through uhat instead)."""
    from ..mesh import Mesh

    disp = _np(displacement).reshape(mesh.n_nodes, mesh.gdim)
    return Mesh(mesh.coords + disp, mesh.conn, mesh.cell_type)


def calculateSurfaceArea(mesh, device=None):
    """Total surface area (linear_shell_fenicsx/utils.py:89). Returns a
    float."""
    from ..models.rm_shell.kinematics import surface_geometry

    dev = resolve_device(device)
    tab = tabulate("P", mesh.cell_type, 1, quad_degree=2)
    gd = torch.as_tensor(tab.geom_dphi, device=dev)
    w = torch.as_tensor(tab.weights, device=dev)

    def cell_area(xc):
        return torch.sum(w * surface_geometry(xc, gd)["dA"])

    x = _cell_coords(mesh, dev)
    if x.shape[-1] == 2:  # a planar mesh: embed it in z = 0
        x = torch.nn.functional.pad(x, (0, 1))
    return float(torch.sum(vmap(cell_area)(x)))


class Delta:
    """Point loads at arbitrary physical points, distributed by the FE
    basis rows of the containing cells (parity with Delta / Delta_cpt /
    Delta_mpt, linear_shell_fenicsx/utils.py:123-199)."""

    def __init__(self, space: FunctionSpace, points, device=None):
        self.space = space
        self.device = resolve_device(device)
        self.rows = point_eval_rows(space, points)

    def apply(self, forces):
        """forces: (n_points, value_size) -> global load vector."""
        vs = self.space.value_size
        F = np.zeros(self.space.n_dofs)
        forces = np.atleast_2d(_np(forces))
        for (_, dofs, wts), f in zip(self.rows, forces):
            for comp in range(vs):
                F[dofs * vs + comp] += wts * f[comp]
        return torch.as_tensor(F, device=self.device)


def computeNodalDisp(space, u):
    """Lagrange (P1 or P2) -> nodal (CG1) displacement values (n_nodes,
    vs) (parity with computeNodalDisp, linear_shell_fenicsx/utils.py:
    105-114): vertex dofs come first in the dof layout, so this is a
    slice."""
    nn = space.mesh.n_nodes
    vs = space.value_size
    return u[: nn * vs].reshape(nn, vs)


def getCellID(coords, mesh):
    """Containing-cell id per physical point (parity with getCellID,
    linear_shell_fenicsx/utils.py:200-218): nearest-midpoint candidates and
    a Newton pull-back on the host (spaces/pointeval.py)."""
    space = FunctionSpace(mesh, "P", 1)
    rows = point_eval_rows(space, np.atleast_2d(_np(coords)))
    return np.array([c for c, _, _ in rows], dtype=np.int64)


def getVertexToDofMap(W):
    """(n_vertices, vs) dof indices of the displacement subspace's vertex
    dofs inside the mixed global vector (parity with getVertexToDofMap,
    linear_shell_fenicsx/utils.py:248-288): sub0 dofs lead the mixed
    vector, vertex scalar dofs lead sub0, components interleaved, so the
    map is an arange."""
    sub = W.subspaces[0] if hasattr(W, "subspaces") else W
    nn, vs = sub.mesh.n_nodes, sub.value_size
    return np.arange(nn * vs, dtype=np.int64).reshape(nn, vs)


def applyNodalForces(f_array, W, device=None):
    """Per-vertex forces (n_vertices, vs) as a W-sized load vector at the
    displacement vertex dofs (parity with applyNodalForces,
    linear_shell_fenicsx/utils.py:227-246)."""
    dev = _device_of(f_array, device)
    F = torch.zeros(W.n_dofs, dtype=torch.float64, device=dev)
    idx = torch.as_tensor(getVertexToDofMap(W).reshape(-1), device=dev)
    F[idx] = tensor_on(f_array, dev, "applyNodalForces").reshape(-1)
    return F


def projectPointForce(space, f_array, tol=1e-12, device=None):
    """Riesz map of a dual (load) vector into `space`: the solve M u = f
    with the consistent mass matrix (parity with projectPointForce,
    linear_shell_fenicsx/utils.py:21-48). Vector spaces solve per
    component against the scalar mass (the vector mass is
    component-block diagonal)."""
    dev = _device_of(f_array, device)
    vs = space.value_size
    scalar = (space if vs == 1 else
              FunctionSpace(space.mesh, space.family, space.degree))
    tab = _tables(scalar, None)
    phi = torch.as_tensor(tab.phi, device=dev)

    def cell_mass(x_cell):
        _, wdet = map_gradients(x_cell, tab)
        return torch.einsum("qa,qb,q->ab", phi, phi, wdet)

    m_c = vmap(cell_mass)(_cell_coords(scalar.mesh, dev))
    f = tensor_on(f_array, dev, "projectPointForce").reshape(
        scalar.n_dofs, vs)
    cols = [_mass_solve(m_c, scalar, f[:, c].contiguous(), tol,
                        10 * scalar.n_dofs) for c in range(vs)]
    return torch.stack(cols, dim=1).reshape(-1) if vs > 1 else cols[0]
