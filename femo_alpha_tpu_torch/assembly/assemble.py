"""Gather -> batched cell kernel -> scatter assembly.

Port of femo_alpha_tpu/assembly/assemble.py. Every cell's local
contribution is one `torch.func.vmap`-batched function of the cell's dofs,
vertex coordinates and parameters; the residual of an energy form is
`torch.func.grad` of the cell energy, the element matrices are `jacfwd` of
that residual. Partial derivatives of the assembled residual with respect
to any parameter come from `torch.func.vjp` through these functions.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

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
    torch.func transform; they are sliced per chunk by cell index."""

    def __init__(self, space, kernel, kind="residual", param_specs=None,
                 cell_consts=None):
        self.space = space
        self.param_specs = dict(param_specs or {})
        self.cell_consts = dict(cell_consts or {})
        if kind == "energy":
            self.energy_kernel = kernel
            self.kernel = grad(kernel, argnums=0)
        else:
            self.energy_kernel = None
            self.kernel = kernel
        self._coords_np = np.asarray(space.mesh.cell_coords())

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
                out[name], dims[name] = sp.gather(v), 0
        return out, dims

    def consts_of(self, cells=None):
        """The cell constants (all cells, or the rows `cells`, an int64
        tensor on their device)."""
        if cells is None:
            return dict(self.cell_consts)
        return {name: v[cells] for name, v in self.cell_consts.items()}

    def cell_values(self, fn, u, params, chunk=None):
        """vmap fn(u_cell, x_cell, pcells) over cells, in blocks of `chunk`
        cells (bounds the peak memory of wide jacfwd batches)."""
        uc = self.space.gather(u)
        pc, dims = self.gather_params(params)
        for name, v in self.consts_of().items():
            pc[name], dims[name] = v, 0
        xc = self.cell_coords(uc.device, uc.dtype)
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

    uc = u[rows(form.space)]
    xc = torch.as_tensor(form._coords_np[cells], dtype=u.dtype, device=dev)
    pc, dims = {}, {}
    for name, sp in form.param_specs.items():
        v = params[name]
        if sp is None:
            pc[name], dims[name] = v, None
        else:
            pc[name], dims[name] = v[rows(sp)], 0
    for name, v in form.consts_of(idx).items():
        pc[name], dims[name] = v, 0
    return vmap(form.energy_kernel, in_dims=(0, 0, dims))(uc, xc, pc).sum()


def element_matrices(form: FemForm, u, params=None, chunk=16384):
    """Per-cell Jacobian dR_cell/du_cell: (nc, nd, nd), cell-major."""
    jac = jacfwd(form.kernel, argnums=0)
    return form.cell_values(jac, u, params or {}, chunk=chunk)


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
    f64 or f32, with no eager op around the kernel."""
    dofmap_T, inv = space.lane_tables(Ae_T.device)
    return constrained_matvec_T(Ae_T, free, dofmap_T, inv)
