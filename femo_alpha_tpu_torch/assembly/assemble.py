"""Gather -> batched cell kernel -> scatter assembly.

Port of femo_alpha_tpu/assembly/assemble.py. Every cell's local
contribution is one `torch.func.vmap`-batched function of the cell's dofs,
vertex coordinates and parameters; the residual of an energy form is
`torch.func.grad` of the cell energy, the element matrices are `jacfwd` of
that residual. Partial derivatives of the assembled residual with respect
to any parameter come from `torch.func.vjp` through these functions.
`FemForm(dtype=float32)` casts every cell input before the kernel, so the
form (with tables of that precision, RMShellPDE(dtype=)) assembles in f32.

The cell-major operator API (`gather_dofs`, `scatter_add`, `cell_matvec`,
`make_matvec`, `transpose_cellwise`, `make_jvp_matvec`) takes element
matrices (nc, nd, nd) as the JAX package's does; on the card every
per-cell product runs a hand-written kernel on the lane-major relayout
(nd, nd, nc): K1 for `cell_matvec`, the fused operator with no mask for
`make_matvec`. Scatters sum in a fixed order (spaces/fixed_order.py).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from ..spaces.fixed_order import fixed_order_scatter, sum_plan
from .cuda_kernels import cell_matvec_T, constrained_matvec_T


class FemForm:
    """A weak form defined by a per-cell kernel over one state space.

    kernel(u_cell, x_cell, params) -> local residual (nd_local,) if
    `kind='residual'`, or a scalar cell energy if `kind='energy'` (the
    residual is then its gradient).

    param_specs: dict name -> FunctionSpace (cell-gathered) or None (value
    passed to every cell unmapped).

    cell_consts: dict name -> fixed per-cell tensor (leading axis cells, in
    the space's cell order, on the device and in the dtype of the state),
    mapped into the kernel beside the gathered parameters (the composite
    laminate's A/B/D/A_s). The caller builds them once, outside every
    torch.func transform; they are sliced per chunk by cell index.

    dtype: cast the cell inputs (gathered dofs and parameters, cell
    constants, vertex coordinates) to this dtype before the kernel; with
    the kernel's tables in the same precision (RMShellPDE(dtype=)) the
    assembly runs in it. None keeps the inputs' dtype."""

    def __init__(self, space, kernel, kind="residual", param_specs=None,
                 cell_consts=None, dtype=None):
        self.space = space
        self.param_specs = dict(param_specs or {})
        self.cell_consts = dict(cell_consts or {})
        self.dtype = dtype
        if kind == "energy":
            self.energy_kernel = kernel
            self.kernel = grad(kernel, argnums=0)
        else:
            self.energy_kernel = None
            self.kernel = kernel
        self._coords_np = np.asarray(space.mesh.cell_coords())

    def _cast(self, a):
        if self.dtype is not None and a.is_floating_point():
            return a.to(self.dtype)
        return a

    def cell_coords(self, device, dtype):
        """(nc, nv, gdim) vertex coordinates of every cell (made per call:
        cell_values may run inside a torch.func transform, whose tensors
        must not be cached)."""
        return torch.as_tensor(self._coords_np, dtype=dtype, device=device)

    def gather_params(self, params):
        out, dims = {}, {}
        for name, sp in self.param_specs.items():
            v = params[name]
            if sp is None:
                out[name], dims[name] = v, None
            else:
                out[name], dims[name] = self._cast(sp.gather(v)), 0
        return out, dims

    def consts_of(self, cells=None):
        """The cell constants (all cells, or the rows `cells`, an int64
        tensor on their device), in the form's dtype."""
        if cells is None:
            return {name: self._cast(v) for name, v in
                    self.cell_consts.items()}
        return {name: self._cast(v[cells])
                for name, v in self.cell_consts.items()}

    def cell_values(self, fn, u, params, chunk=None, cells=None):
        """vmap fn(u_cell, x_cell, pcells) over cells, in blocks of `chunk`
        cells (bounds the peak memory of wide jacfwd batches). cells: a
        range (c0, c1) to run over those cells only (one rank's share of
        a cell-split operator), gathering only their rows."""
        if cells is None:
            uc = self._cast(self.space.gather(u))
            pc, dims = self.gather_params(params)
            consts = self.consts_of()
            xc = self.cell_coords(u.device, uc.dtype)
        else:
            c0, c1 = cells

            def rows(space, v):
                idx = torch.as_tensor(space.dofmap[c0:c1], dtype=torch.int64,
                                      device=v.device)
                return v[idx]

            uc = self._cast(rows(self.space, u))
            pc, dims = {}, {}
            for name, sp in self.param_specs.items():
                v = params[name]
                pc[name], dims[name] = ((v, None) if sp is None else
                                        (self._cast(rows(sp, v)), 0))
            consts = self.consts_of(torch.arange(c0, c1, device=u.device))
            xc = torch.as_tensor(self._coords_np[c0:c1], dtype=uc.dtype,
                                 device=u.device)
        for name, v in consts.items():
            pc[name], dims[name] = v, 0
        batched = vmap(fn, in_dims=(0, 0, dims))
        nc = uc.shape[0]
        if chunk is None or nc <= chunk:
            return batched(uc, xc, pc)
        outs = []
        for s in range(0, nc, chunk):
            sl = slice(s, min(s + chunk, nc))
            p_s = {k: (v[sl] if dims[k] == 0 else v) for k, v in pc.items()}
            outs.append(batched(uc[sl], xc[sl], p_s))
        return torch.cat(outs)


def assemble_residual(form: FemForm, u, params=None, chunk=16384):
    """Assembled residual vector (n_dofs,)."""
    rc = form.cell_values(form.kernel, u, params or {}, chunk=chunk)
    return form.space.scatter_add(rc)


def assemble_scalar(form: FemForm, u, params=None):
    """Sum of cell energies of an energy-kind form (a global functional)."""
    return form.cell_values(form.energy_kernel, u, params or {}).sum()


def assemble_scalar_subset(form: FemForm, u, params, cells):
    """Sum of the cell energies of an energy-kind form over a fixed subset
    of cells (host integer indices): O(|subset|) gather and kernel work, as
    the per-tag stress outputs need."""
    cells = np.asarray(cells, dtype=np.int64)
    dev = u.device
    idx = torch.as_tensor(cells, device=dev)

    def rows(space):
        return torch.as_tensor(space.dofmap, dtype=torch.int64,
                               device=dev)[idx]

    uc = form._cast(u[rows(form.space)])
    xc = torch.as_tensor(form._coords_np[cells], dtype=uc.dtype, device=dev)
    pc, dims = {}, {}
    for name, sp in form.param_specs.items():
        v = params[name]
        if sp is None:
            pc[name], dims[name] = v, None
        else:
            pc[name], dims[name] = form._cast(v[rows(sp)]), 0
    for name, v in form.consts_of(idx).items():
        pc[name], dims[name] = v, 0
    return vmap(form.energy_kernel, in_dims=(0, 0, dims))(uc, xc, pc).sum()


def element_matrices(form: FemForm, u, params=None, chunk=16384,
                     cells=None):
    """Per-cell Jacobian dR_cell/du_cell: (nc, nd, nd), cell-major; over
    the cell range cells = (c0, c1) only when given."""
    jac = jacfwd(form.kernel, argnums=0)
    return form.cell_values(jac, u, params or {}, chunk=chunk, cells=cells)


# --------------------------------------------------------------------------
# the cell-major operator API
# --------------------------------------------------------------------------


def _dofmap_spec(dofmap, n_dofs):
    """A raw (nc, nd) dofmap as an op spec with lane tables and a plan
    cache (assembly/facets.py::FacetBlock), one per dofmap and size."""
    from .facets import FacetBlock

    dm = np.ascontiguousarray(
        dofmap.cpu().numpy() if torch.is_tensor(dofmap) else dofmap,
        dtype=np.int32)
    key = (dm.shape, int(n_dofs), hashlib.sha1(dm.tobytes()).hexdigest())
    spec = _SPECS.get(key)
    if spec is None:
        spec = _SPECS[key] = FacetBlock(dm, n_dofs)
    return spec


_SPECS = {}


def gather_dofs(x, dofmap):
    """Cell gather: x (n_dofs,), dofmap (nc, nd) -> (nc, nd)."""
    dm = torch.as_tensor(dofmap, device=x.device).long()
    return x.index_select(0, dm.reshape(-1)).view(dm.shape)


def scatter_add(dofmap, cell_vals, n_dofs):
    """Scatter-add per-cell local vectors (nc, nd) into a global vector
    (n_dofs,): each dof sums its entries in cell-major order
    (spaces/fixed_order.py), without atomics."""
    spec = _dofmap_spec(dofmap, n_dofs)
    plan = sum_plan(spec, "scatter", spec.dofmap, cell_vals.device)
    return fixed_order_scatter(cell_vals.reshape(-1), plan, spec.n_dofs)


def transpose_cellwise(Ae):
    """(nc, nd, nd) -> (nd, nd, nc): the lane-major relayout of element
    matrices (a view; `transpose_cellwise_inv` goes back)."""
    return Ae.movedim(0, -1)


def transpose_cellwise_inv(Ae_T):
    return Ae_T.movedim(-1, 0)


def cell_matvec(Ae, xc):
    """Per-cell matvec yc[c, i] = sum_j Ae[c, i, j] xc[c, j] of cell-major
    element matrices, in the promoted dtype of the two: K1 on the
    lane-major relayout (its plain twin on CPU tensors)."""
    dt = torch.promote_types(Ae.dtype, xc.dtype)
    Ae_T = transpose_cellwise(Ae.to(dt)).contiguous()
    return cell_matvec_T(Ae_T, xc.to(dt).T.contiguous()).T


def make_matvec(Ae, spec, n_dofs=None):
    """Matrix-free operator x -> A @ x from cell-major element matrices
    (nc, nd, nd). spec: a FunctionSpace / MixedSpace, or a raw (nc, nd)
    dofmap with an explicit n_dofs. The matrices are relaid lane-major
    once; each application is one pass of the fused operator with no mask
    (free = 1: gather, per-cell product and fixed-order dof sums in one
    kernel call on the card), in the promoted dtype of Ae and x, as the
    JAX package's make_matvec promotes."""
    if not hasattr(spec, "lane_tables"):
        if n_dofs is None:
            raise ValueError("make_matvec: a raw dofmap needs n_dofs")
        spec = _dofmap_spec(spec, n_dofs)
    Ae_T = transpose_cellwise(Ae).contiguous()
    ops = {}

    def matvec(x):
        dt = torch.promote_types(Ae_T.dtype, x.dtype)
        op = ops.get(dt)
        if op is None:
            A = Ae_T.to(dt)
            ones = torch.ones(spec.n_dofs, dtype=dt, device=A.device)
            op = ops[dt] = make_constrained_matvec_T(A, spec, ones)
        return op(x.to(dt).contiguous())

    return matvec


def make_jvp_matvec(residual_fn, u):
    """Matrix-free Jacobian-vector operator v -> dR(u)[v] of an assembled
    residual, by linearization at u (torch.func.linearize): for nonlinear
    problems whose element matrices are not cached."""
    _, lin = torch.func.linearize(residual_fn, u)
    return lin


def make_matvec_T(Ae_T, space):
    """Matrix-free operator x -> A @ x from LANE-MAJOR element matrices
    (nd, nd, nc): the space's lane-major gather, the K1 per-cell matvec,
    and the explicit adjoint scatter."""

    def matvec(x):
        ycT = cell_matvec_T(Ae_T, space.gather_T(x).contiguous())
        return space.scatter_add_T(ycT)

    return matvec


def make_constrained_matvec_T(Ae_T, space, free):
    """The strong-BC operator x -> free*A(free*x) + (1-free)*x from
    LANE-MAJOR element matrices (nd, nd, nc), as one fused pass over them
    (cuda_kernels.constrained_matvec_T on the space's cached index tables):
    what constrain_matvec(make_matvec_T(Ae_T, space), free) computes, in
    f64 or f32, with no eager op around the kernel. On one rank's cells of
    a cell-split operator (space a spaces.CellRange, Ae_T its cells) the
    kernel runs over those cells and one all_reduce sums the ranks'
    results, the identity term counted once (CellShardSpec.split_operator).
    """
    dofmap_T, inv = space.lane_tables(Ae_T.device)
    op = constrained_matvec_T(Ae_T, free, dofmap_T, inv)
    comm = getattr(space, "comm", None)
    return op if comm is None else comm.split_operator(op, free)
