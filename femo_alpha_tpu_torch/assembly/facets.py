"""Exterior- and interior-facet integrals (the reference's ds / dS
measures and the penalty-BC facet terms).

Port of femo_alpha_tpu/assembly/facets.py. Facets are grouped by their
local-facet id; each group has static basis tables (evaluated at the edge
quadrature points mapped into the cell's reference domain) and is one
`torch.func.vmap` batch over the OWNING cells' data: the kernel sees the
whole cell (its dofs, vertices and parameters) and evaluates traces with
the edge tables. The residual is `torch.func.grad` of the facet energy,
the element matrices `jacfwd` of that.

The element matrices of all groups come out as ONE lane-major block
(nd, nd, n_facets) over the owning cells' dofmap rows (`FacetBlock`), so
the solver applies them with the same fused operator kernel as the cell
block.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from ..elements import reference_element
from ..elements.quadrature import quadrature_rule
from ..spaces.fixed_order import fixed_order_scatter, sum_plan
from ..spaces.space import _LaneTables

# local edge parametrizations xi(t), t in [0,1], and d(xi)/dt
_EDGE_PARAM = {
    "triangle": [
        (lambda t: np.stack([t, 0 * t], 1), np.array([1.0, 0.0])),
        (lambda t: np.stack([1 - t, t], 1), np.array([-1.0, 1.0])),
        (lambda t: np.stack([0 * t, 1 - t], 1), np.array([0.0, -1.0])),
    ],
    "quad": [
        (lambda t: np.stack([t, 0 * t], 1), np.array([1.0, 0.0])),
        (lambda t: np.stack([1 + 0 * t, t], 1), np.array([0.0, 1.0])),
        (lambda t: np.stack([1 - t, 1 + 0 * t], 1), np.array([-1.0, 0.0])),
        (lambda t: np.stack([0 * t, 1 - t], 1), np.array([0.0, -1.0])),
    ],
}


class EdgeTables:
    """Static tables for one local-facet id: reference points on the cell,
    1D weights, d(xi)/dt, and tabulated bases of requested elements
    (numpy)."""

    def __init__(self, cell_type, local_id, quad_degree, families):
        t, w = quadrature_rule("interval", quad_degree)
        t = t[:, 0]
        param, dxi_dt = _EDGE_PARAM[cell_type][local_id]
        self.points = param(t)  # (nq, 2)
        self.weights = w
        self.dxi_dt = dxi_dt  # (2,)
        self.local_id = local_id
        self.tabs = {}
        for key in families:  # key = (family, degree)
            elem = reference_element(key[0], cell_type, key[1])
            self.tabs[key] = (
                elem.tabulate(self.points, 0),
                elem.tabulate(self.points, 1),
            )
        geom = reference_element("P", cell_type, 1)
        self.geom_phi = geom.tabulate(self.points, 0)
        self.geom_dphi = geom.tabulate(self.points, 1)


def select_facets(mesh, predicate):
    """Exterior facets whose midpoints satisfy predicate(coords (n,gdim)) ->
    bool mask: (cells, local facet ids)."""
    cells, locals_, verts = mesh.exterior_facets()
    mids = mesh.coords[verts].mean(axis=1)
    mask = np.asarray(predicate(mids)).astype(bool)
    return cells[mask], locals_[mask]


class FacetBlock(_LaneTables):
    """The op spec of a facet block: the owning cells' dofmap rows
    (n_facets, nd) over a space of n_dofs, with the fused operator's index
    tables (`lane_tables`, cached per device)."""

    def __init__(self, dofmap, n_dofs):
        self.dofmap = np.ascontiguousarray(dofmap, dtype=np.int32)
        self.n_dofs = int(n_dofs)
        self._index_cache = {}


class FacetForm:
    """A facet integral defined by an energy kernel per facet.

    kernel_factory(tabs: EdgeTables) -> energy(u_cell, x_cell, pcells),
    where u_cell / x_cell / pcells are the owning CELL's data; the factory
    makes the torch tables it closes over (on the form's device) itself.
    param_specs: dict name -> FunctionSpace (gathered on the owning cells).
    """

    def __init__(self, space, kernel_factory, facet_cells, facet_locals,
                 param_specs=None, quad_degree=4, families=()):
        self.space = space
        self.param_specs = dict(param_specs or {})
        mesh = space.mesh
        self._coords_np = np.asarray(mesh.cell_coords())
        self.groups = []
        n_local = 3 if mesh.cell_type == "triangle" else 4
        facet_cells = np.asarray(facet_cells)
        facet_locals = np.asarray(facet_locals)
        for lid in range(n_local):
            sel = np.where(facet_locals == lid)[0]
            if len(sel) == 0:
                continue
            energy = kernel_factory(
                EdgeTables(mesh.cell_type, lid, quad_degree, families))
            self.groups.append(dict(
                cells=facet_cells[sel].astype(np.int64),
                energy=energy,
                kernel=grad(energy, argnums=0),
                jac=jacfwd(grad(energy, argnums=0), argnums=0)))
        cells = (np.concatenate([g["cells"] for g in self.groups])
                 if self.groups else np.zeros(0, dtype=np.int64))
        self.cells = cells
        self.block = FacetBlock(space.dofmap[cells], space.n_dofs)

    def _batch(self, fn, u, params, cells):
        """vmap fn over the owning cells `cells` (numpy)."""
        dev = u.device
        idx = torch.as_tensor(cells, device=dev)
        dm = torch.as_tensor(self.space.dofmap, dtype=torch.int64,
                             device=dev)[idx]
        uc = u[dm]
        xc = torch.as_tensor(self._coords_np[cells], dtype=u.dtype,
                             device=dev)
        pc, dims = {}, {}
        for name, sp in self.param_specs.items():
            v = params[name]
            if sp is None:
                pc[name], dims[name] = v, None
            else:
                pdm = torch.as_tensor(sp.dofmap, dtype=torch.int64,
                                      device=dev)[idx]
                pc[name], dims[name] = v[pdm], 0
        return vmap(fn, in_dims=(0, 0, dims))(uc, xc, pc)

    def assemble_residual(self, u, params):
        """The facet residual (n_dofs,): each dof sums its entries of all
        groups in `self.block.dofmap` order (fixed_order.py), without
        atomics."""
        if not self.groups:
            return u.new_zeros(self.space.n_dofs)
        rc = torch.cat([self._batch(g["kernel"], u, params, g["cells"])
                        for g in self.groups])
        plan = sum_plan(self.block, "residual", self.block.dofmap, u.device)
        return fixed_order_scatter(rc.reshape(-1), plan, self.space.n_dofs)

    def assemble_scalar(self, u, params):
        total = u.new_zeros(())
        for g in self.groups:
            e = self._batch(g["energy"], u, params, g["cells"])
            total = total + e.sum()
        return total

    def element_ops(self, u, params):
        """The facet element matrices of all groups as one lane-major
        (nd, nd, n_facets) block, in the order of `self.block.dofmap`."""
        mats = [self._batch(g["jac"], u, params, g["cells"])
                for g in self.groups]
        return torch.cat(mats).permute(1, 2, 0).contiguous()
