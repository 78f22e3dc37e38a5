"""Function spaces: dofmaps, dof coordinates and cell gather/scatter.

Port of femo_alpha_tpu/spaces/space.py. Dofmaps are built once in numpy;
the per-cell gather/scatter run on whatever device the vector lives on.

Local dof ordering inside a cell:
  scalar: [vertex dofs (element order), edge dofs, cell dofs]
  vector (value_size=vs): interleaved — local index a*vs + c for scalar
  dof a, component c; globally dof = scalar_dof*vs + c.

Every scatter is written as the explicit adjoint stencil of its gather
(slice-adds into a fresh tensor, or spaces/fixed_order.py's fixed-order
sums, which add without atomics), never derived by
transposing the gather through autograd: the JAX package found its derived
transposes miscompiled at large grids (femo_alpha_tpu/spaces/space.py
scatter_add_T), so the port keeps the hand-written form.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, tensor_on
from ..elements import reference_element, tabulate
from ..mesh import Mesh
from .fixed_order import fixed_order_scatter, sum_plan


def _build_scalar_dofmap(mesh: Mesh, elem):
    """Returns (dofmap (n_cells, nd) int32, n_scalar_dofs)."""
    nv_d, ne_d, nc_d = elem.entity_dofs
    mesh._build_topology()
    cols = []
    n_local_vertices = mesh.conn.shape[1]
    if nv_d > 0:
        for v in range(n_local_vertices):
            for k in range(nv_d):
                cols.append(nv_d * mesh.conn[:, v] + k)
    off_e = nv_d * mesh.n_nodes
    if ne_d > 0:
        for e in range(mesh.cell_edges.shape[1]):
            for k in range(ne_d):
                cols.append(off_e + ne_d * mesh.cell_edges[:, e] + k)
    off_c = off_e + ne_d * mesh.n_edges
    if nc_d > 0:
        cid = np.arange(mesh.n_cells)
        for k in range(nc_d):
            cols.append(off_c + nc_d * cid + k)
    dofmap = np.stack(cols, axis=1).astype(np.int32)
    n_dofs = off_c + nc_d * mesh.n_cells
    assert dofmap.shape[1] == elem.ndof, (dofmap.shape, elem.ndof)
    return dofmap, n_dofs


def lane_index_tables(dofmap, n_dofs):
    """The index tables of the fused constrained operator for any dofmap
    (nc, nd): dofmap_T (nd, nc) int32, lane-major, and inv (n_dofs, w)
    int32, which lists for each dof its flat cell-value entries i*nc + c
    (local row i, cell c) in increasing order, padded with -1; w is the
    largest number of entries of one dof (4 on quad meshes)."""
    nc, nd = dofmap.shape
    dofmap_T = np.ascontiguousarray(dofmap.T, dtype=np.int32)
    flat = dofmap_T.reshape(-1).astype(np.int64)
    order = np.argsort(flat, kind="stable")  # entries of a dof stay sorted
    counts = np.bincount(flat, minlength=n_dofs)
    starts = np.cumsum(counts) - counts
    dofs = flat[order]
    inv = np.full((n_dofs, max(int(counts.max()), 1)), -1, dtype=np.int32)
    inv[dofs, np.arange(flat.size) - starts[dofs]] = order
    return dofmap_T, inv


class _LaneTables:
    """Spaces with a `dofmap`, `n_dofs` and an `_index_cache` dict."""

    def lane_tables(self, device, cells=None):
        """(dofmap_T, inv) of `lane_index_tables` on `device`, built once
        and cached per device: over every cell, or over the cell range
        cells = (c0, c1) (dofmap_T (nd, c1 - c0), and inv's entries index
        that range's (nd, c1 - c0) cell values; dofs keep the space's
        numbering)."""
        key = ("lane", str(device)) if cells is None else (
            "lane", str(device), tuple(cells))
        tables = self._index_cache.get(key)
        if tables is None:
            dm = self.dofmap if cells is None else \
                self.dofmap[cells[0]:cells[1]]
            tables = self._index_cache[key] = tuple(
                torch.as_tensor(t, device=device)
                for t in lane_index_tables(dm, self.n_dofs))
        return tables


class _StructuredLayout:
    """Slice gathers and slice-add scatters for grid-ordered dofs on a
    StructuredQuadMesh (mesh/structured.py), in the cell-major (nc, nd)
    and lane-major (nd, nc) layouts.

    `parts(x)` returns the per-local-node (nx, ny, vs) views of a global
    vector; `accumulate(g)` is its exact adjoint: it adds each local
    node's (nx, ny, vs) block back onto the dof grids."""

    def __init__(self, mesh, family, degree, vs):
        self.nx, self.ny, self.vs = mesh.nx, mesh.ny, vs
        self.kind = None
        if family in ("P", "CG", "Lagrange", "Q") and degree in (1, 2):
            self.kind = f"P{degree}"
            self.nloc = 4 if degree == 1 else 9
        elif family == "DG" and degree in (0, 1):
            self.kind = "DG"
            self.nloc = 1 if degree == 0 else 4

    def parts(self, x):
        nx, ny, vs = self.nx, self.ny, self.vs
        if self.kind == "DG":
            return [x.reshape(nx, ny, self.nloc, vs)[:, :, a]
                    for a in range(self.nloc)]
        nV = (nx + 1) * (ny + 1) * vs
        V = x[:nV].reshape(nx + 1, ny + 1, vs)
        out = [V[:-1, :-1], V[1:, :-1], V[1:, 1:], V[:-1, 1:]]
        if self.kind == "P2":
            nEX = nx * (ny + 1) * vs
            nEY = (nx + 1) * ny * vs
            EX = x[nV:nV + nEX].reshape(nx, ny + 1, vs)
            EY = x[nV + nEX:nV + nEX + nEY].reshape(nx + 1, ny, vs)
            C = x[nV + nEX + nEY:].reshape(nx, ny, vs)
            out += [EX[:, :-1], EY[1:, :], EX[:, 1:], EY[:-1, :], C]
        return out

    def accumulate(self, g):
        """Adjoint of `parts`: g (nloc, nx, ny, vs) -> (n_dofs,)."""
        nx, ny, vs = self.nx, self.ny, self.vs
        if self.kind == "DG":
            return g.permute(1, 2, 0, 3).reshape(-1)
        V = g.new_zeros((nx + 1, ny + 1, vs))
        V[:-1, :-1] += g[0]
        V[1:, :-1] += g[1]
        V[1:, 1:] += g[2]
        V[:-1, 1:] += g[3]
        if self.kind == "P1":
            return V.reshape(-1)
        EX = g.new_zeros((nx, ny + 1, vs))
        EX[:, :-1] += g[4]
        EX[:, 1:] += g[6]
        EY = g.new_zeros((nx + 1, ny, vs))
        EY[1:, :] += g[5]
        EY[:-1, :] += g[7]
        return torch.cat([V.reshape(-1), EX.reshape(-1), EY.reshape(-1),
                          g[8].reshape(-1)])

    def gather(self, x):
        nc = self.nx * self.ny
        return torch.stack(self.parts(x), dim=2).reshape(
            nc, self.nloc * self.vs)

    def scatter(self, cv):
        g = cv.reshape(self.nx, self.ny, self.nloc, self.vs)
        return self.accumulate(g.permute(2, 0, 1, 3))

    def gather_T(self, x):
        G = torch.stack(self.parts(x), dim=0)  # (nloc, nx, ny, vs)
        return G.permute(0, 3, 1, 2).reshape(
            self.nloc * self.vs, self.nx * self.ny)

    def scatter_T(self, cvT):
        g = cvT.reshape(self.nloc, self.vs, self.nx, self.ny)
        return self.accumulate(g.permute(0, 2, 3, 1))


class FunctionSpace(_LaneTables):
    """A (possibly vector-valued) finite element space on a mesh."""

    def __init__(self, mesh: Mesh, family: str, degree: int,
                 value_size: int = 1):
        self.mesh = mesh
        self.family = family
        self.degree = degree
        self.value_size = value_size
        self.element = reference_element(family, mesh.cell_type, degree)
        self.scalar_dofmap, self.n_scalar_dofs = _build_scalar_dofmap(
            mesh, self.element)
        self.n_dofs = self.n_scalar_dofs * value_size
        self.nd_local = self.element.ndof * value_size
        if value_size == 1:
            self.dofmap = self.scalar_dofmap
        else:
            vs = value_size
            self.dofmap = (
                self.scalar_dofmap[:, :, None] * vs
                + np.arange(vs)[None, None, :]
            ).reshape(mesh.n_cells, -1).astype(np.int32)
        self._dof_coords = None
        self._layout = None
        if getattr(mesh, "structured", False):
            lay = _StructuredLayout(mesh, family, degree, value_size)
            if lay.kind is not None:
                self._layout = lay
        self._index_cache = {}

    def _dofmap_on(self, device):
        key = str(device)
        idx = self._index_cache.get(key)
        if idx is None:
            idx = self._index_cache[key] = torch.as_tensor(
                self.dofmap, dtype=torch.int64, device=device)
        return idx

    # ------------------------------------------------- gather/scatter
    def gather(self, x):
        """(n_dofs,) -> (nc, nd_local) cell-dof values."""
        if self._layout is not None:
            return self._layout.gather(x)
        return x[self._dofmap_on(x.device)]

    def scatter_add(self, cell_vals):
        """(nc, nd_local) -> (n_dofs,) scatter-add; each dof sums its
        entries in cell-major order (fixed_order.py), without atomics."""
        if self._layout is not None:
            return self._layout.scatter(cell_vals)
        plan = sum_plan(self, "scatter", self.dofmap, cell_vals.device)
        return fixed_order_scatter(cell_vals.reshape(-1), plan, self.n_dofs)

    def gather_T(self, x):
        """(n_dofs,) -> (nd_local, nc) lane-major cell-dof values."""
        if self._layout is not None:
            return self._layout.gather_T(x)
        return self.gather(x).T.contiguous()

    def scatter_add_T(self, cell_vals_T):
        """(nd_local, nc) -> (n_dofs,): the exact adjoint of gather_T."""
        if self._layout is not None:
            return self._layout.scatter_T(cell_vals_T)
        return self.scatter_add(cell_vals_T.T)

    # ------------------------------------------------------------- coords
    @property
    def dof_coords(self):
        """(n_scalar_dofs, gdim) physical coordinates of each scalar dof."""
        if self._dof_coords is None:
            elem = self.element
            geom = reference_element("P", self.mesh.cell_type, 1)
            gphi = geom.tabulate(elem.node_coords, 0)  # (nd, nv)
            pos = np.einsum("ab,cbg->cag", gphi, self.mesh.cell_coords())
            coords = np.zeros((self.n_scalar_dofs, self.mesh.gdim))
            coords[self.scalar_dofmap.ravel()] = pos.reshape(
                -1, self.mesh.gdim)
            self._dof_coords = coords
        return self._dof_coords

    def tabulate(self, quad_degree=None, with_hessian=False, points=None,
                 weights=None):
        """The element's tables (elements.ElementTables, numpy) at a Gauss
        rule of `quad_degree` or at the given points and weights."""
        return tabulate(self.family, self.mesh.cell_type, self.degree,
                        quad_degree=quad_degree, with_hessian=with_hessian,
                        points=points, weights=weights)

    def __repr__(self):
        return (f"FunctionSpace({self.element.name}, vs={self.value_size}, "
                f"ndofs={self.n_dofs})")

    def function(self, array=None, name=None, device=None):
        return Function(self, array=array, name=name, device=device)


class MixedSpace(_LaneTables):
    """Concatenation of function spaces (e.g. RM shell: CG2 vec3 x CG1 vec3).

    Global vector = [sub0 dofs | sub1 dofs | ...]; per-cell local dofs are
    the concatenation of each sub's local dofs."""

    def __init__(self, *subspaces: FunctionSpace):
        self.subspaces = list(subspaces)
        self.mesh = subspaces[0].mesh
        self.offsets = np.cumsum([0] + [s.n_dofs for s in self.subspaces])
        self.n_dofs = int(self.offsets[-1])
        self.nd_local = sum(s.nd_local for s in self.subspaces)
        maps = [s.dofmap + off
                for s, off in zip(self.subspaces, self.offsets[:-1])]
        self.dofmap = np.concatenate(maps, axis=1).astype(np.int32)
        self._index_cache = {}
        self.local_slices = []
        o = 0
        for s in self.subspaces:
            self.local_slices.append(slice(o, o + s.nd_local))
            o += s.nd_local

    def split(self, x):
        """Split a global mixed vector into per-subspace vectors."""
        return [x[int(self.offsets[i]): int(self.offsets[i + 1])]
                for i in range(len(self.subspaces))]

    def gather(self, x):
        return torch.cat([s.gather(xi) for s, xi in
                          zip(self.subspaces, self.split(x))], dim=1)

    def scatter_add(self, cell_vals):
        return torch.cat([s.scatter_add(cell_vals[:, sl]) for s, sl in
                          zip(self.subspaces, self.local_slices)])

    def gather_T(self, x):
        """(n_dofs,) -> (nd_local, nc) lane-major cell-dof values."""
        return torch.cat([s.gather_T(xi) for s, xi in
                          zip(self.subspaces, self.split(x))], dim=0)

    def scatter_add_T(self, cell_vals_T):
        """(nd_local, nc) -> (n_dofs,) lane-major scatter-add."""
        return torch.cat([s.scatter_add_T(cell_vals_T[sl]) for s, sl in
                          zip(self.subspaces, self.local_slices)])

    def function(self, array=None, name=None, device=None):
        return Function(self, array=array, name=name, device=device)


class CellRange(_LaneTables):
    """The cells c0:c1 of a space (a FunctionSpace or a MixedSpace) as one
    rank of a cell-split operator holds them (parallel/product.py).

    Cell-indexed data covers the range only: `dofmap` (and each
    subspace's `scalar_dofmap`) are the range's rows, `gather` /
    `gather_T` give the range's cell values, and `lane_tables` index the
    range's (nd, c1 - c0) cell values. Dof vectors keep the whole space's
    numbering, and what sums cell values into dofs returns the sum over
    every rank's cells, replicated: `scatter_add` / `scatter_add_T` and
    the fused operator on the range (assembly/assemble.py) end in one
    `comm.all_reduce`."""

    def __init__(self, space, c0, c1, comm):
        self.space, self.cells, self.comm = space, (int(c0), int(c1)), comm
        self.nc = int(c1) - int(c0)
        self.mesh = space.mesh
        self.n_dofs = space.n_dofs
        self.nd_local = space.nd_local
        self.dofmap = space.dofmap[c0:c1]
        self._index_cache = {}
        for name in ("family", "degree", "value_size", "element",
                     "n_scalar_dofs", "offsets", "local_slices"):
            if hasattr(space, name):
                setattr(self, name, getattr(space, name))
        if hasattr(space, "scalar_dofmap"):
            self.scalar_dofmap = space.scalar_dofmap[c0:c1]
        if hasattr(space, "subspaces"):
            self.subspaces = [CellRange(sub, c0, c1, comm)
                              for sub in space.subspaces]

    def lane_tables(self, device, cells=None):
        """The whole space's lane tables over this range (cached there)."""
        return self.space.lane_tables(device, cells=self.cells)

    def _rows(self, device):
        key = ("rows", str(device))
        idx = self._index_cache.get(key)
        if idx is None:
            idx = self._index_cache[key] = torch.as_tensor(
                self.dofmap, dtype=torch.int64, device=device)
        return idx

    def split(self, x):
        return self.space.split(x)

    def gather(self, x):
        """(n_dofs,) -> (c1 - c0, nd_local): the range's cell values."""
        return x[self._rows(x.device)]

    def gather_T(self, x):
        return self.gather(x).T.contiguous()

    def partial_scatter_add(self, cell_vals):
        """(c1 - c0, nd_local) -> (n_dofs,): this rank's range alone, summed
        in a fixed order (differentiable; not summed over the ranks)."""
        plan = sum_plan(self, "scatter", self.dofmap, cell_vals.device)
        return fixed_order_scatter(cell_vals.reshape(-1), plan, self.n_dofs)

    def scatter_add(self, cell_vals):
        """(c1 - c0, nd_local) on every rank -> (n_dofs,): each rank sums
        its range in a fixed order, then one all_reduce."""
        return self.comm.all_reduce(self.partial_scatter_add(cell_vals))

    def scatter_add_T(self, cell_vals_T):
        return self.scatter_add(cell_vals_T.T)


class Function:
    """A coefficient vector in a space: `.x` is an f64 tensor of n_dofs on
    `device` (the CUDA card unless named)."""

    def __init__(self, space, array=None, name=None, device=None):
        self.space = space
        self.name = name
        self.device = resolve_device(device)
        if array is None:
            self.x = torch.zeros(space.n_dofs, dtype=torch.float64,
                                 device=self.device)
        else:
            self.x = tensor_on(array, self.device, "Function").reshape(
                space.n_dofs)

    def interpolate(self, fn):
        """Interpolate a callable fn(coords (n, gdim)) -> (n,) or (n, vs)
        at the dof coordinates (Lagrange spaces only)."""
        vals = np.asarray(fn(self.space.dof_coords), dtype=np.float64)
        self.x = torch.as_tensor(vals.reshape(-1), device=self.device)
        return self

    def copy(self):
        return Function(self.space, array=self.x.clone(), name=self.name,
                        device=self.device)


def locate_dofs_geometric(space: FunctionSpace, predicate, component=None):
    """Global dof indices whose coordinates satisfy `predicate(coords)->bool`.

    Parity with dolfinx locate_dofs_geometrical. `component=None` selects
    all value components; an int selects one."""
    mask = np.asarray(predicate(space.dof_coords)).astype(bool)
    scalar_dofs = np.where(mask)[0]
    vs = space.value_size
    if vs == 1:
        return scalar_dofs.astype(np.int32)
    if component is None:
        return (scalar_dofs[:, None] * vs + np.arange(vs)[None, :]).reshape(
            -1).astype(np.int32)
    return (scalar_dofs * vs + component).astype(np.int32)
