"""Point and node-block Jacobi preconditioners from element matrices.

Port of femo_alpha_tpu/solvers/precond.py on the port's lane-major element
blocks Ae (nd, nd, nc). Every diagonal (or diagonal block) is summed over
the cells through the fixed-order scatter of spaces/fixed_order.py (or a
structured space's slice adds), never with atomics, so one operator always
gives the same preconditioner bits.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..spaces.fixed_order import fixed_order_scatter, sum_plan


def scatter_cell_values(spec, vals_T, size):
    """(nd, nc) lane-major cell values -> (size, ...) summed per dof of
    spec's (nc, nd) dofmap: the space's own scatter_add_T where it has one
    (slice adds on structured grids), else a fixed-order sum whose plan is
    cached on spec (a FunctionSpace or a facet block)."""
    if hasattr(spec, "scatter_add_T"):
        return spec.scatter_add_T(vals_T)
    plan = sum_plan(spec, "diag", np.asarray(spec.dofmap).T, vals_T.device)
    return fixed_order_scatter(vals_T.reshape((-1,) + vals_T.shape[2:]),
                               plan, size)


def jacobi_from_blocks(ops, n_dofs, free_mask=None):
    """Point Jacobi of a sum of lane-major element blocks
    [(Ae_T (nd, nd, nc), spec)]: their diagonals summed per dof, the BC
    diagonal 1 where free_mask is 0, zeros left as ones. Returns
    M: v -> D^{-1} v."""
    diag = None
    for Ae_T, spec in ops:
        d = scatter_cell_values(
            spec, torch.diagonal(Ae_T, dim1=0, dim2=1).T.contiguous(), n_dofs)
        diag = d if diag is None else diag + d
    if free_mask is not None:
        diag = free_mask * diag + (1.0 - free_mask)
    inv = torch.where(diag != 0.0, 1.0 / diag, torch.ones_like(diag))

    def M(v):
        return inv * v

    return M


def jacobi_preconditioner(Ae_T, spec, n_dofs, free_mask=None):
    """Point Jacobi from the diagonals of lane-major element matrices
    Ae_T (nd, nd, nc) over spec's dofmap. Returns M: v -> D^{-1} v.

    With a constrained operator (identity on BC dofs) pass free_mask so the
    BC diagonal is 1."""
    return jacobi_from_blocks([(Ae_T, spec)], n_dofs, free_mask)


def _block_inverse(blocks, scalar_dofmap, n_scalar, bs, fm, owner):
    """Sum per-cell (nc, nds, bs, bs) diagonal blocks per scalar dof in a
    fixed order, mask the constrained components (fm (n_scalar, bs) or
    None), put identities where a block is empty, and invert."""
    nc, nds = blocks.shape[:2]
    plan = sum_plan(owner, ("blockdiag", bs), scalar_dofmap, blocks.device)
    D = fixed_order_scatter(blocks.reshape(nc * nds, bs * bs), plan,
                            n_scalar).reshape(n_scalar, bs, bs)
    eye = torch.eye(bs, dtype=blocks.dtype, device=blocks.device)[None]
    if fm is not None:
        D = D * fm[:, :, None] * fm[:, None, :] + eye * (1.0 - fm)[:, :, None]
    dd = torch.abs(torch.diagonal(D, dim1=1, dim2=2)).sum(dim=1)
    D = torch.where((dd == 0.0)[:, None, None], eye, D)
    return torch.linalg.inv(D)


def _diag_blocks(Ae_T, o, nds, bs):
    """(nc, nds, bs, bs): the bs x bs diagonal blocks of the local nodes
    o/bs .. o/bs + nds of lane-major element matrices."""
    nc = Ae_T.shape[2]
    sub = Ae_T[o: o + nds * bs, o: o + nds * bs].reshape(nds, bs, nds, bs,
                                                         nc)
    a = torch.arange(nds, device=Ae_T.device)
    return sub[a, :, a].permute(3, 0, 1, 2)  # (nds, bs, bs, nc) -> cells


def mixed_block_jacobi(Ae_T, W, free_mask=None):
    """Node-block Jacobi for a MixedSpace of vector subspaces (the RM
    shell's CG2(vec3) x CG1(vec3)): per scalar node the value_size x
    value_size diagonal block, summed over cells and inverted in batch.
    Returns M: v -> block-solved v."""
    appliers = []
    for i, sub in enumerate(W.subspaces):
        o = W.local_slices[i].start
        bs = sub.value_size
        nds = sub.element.ndof
        o_g = int(W.offsets[i])
        fm = None
        if free_mask is not None:
            fm = free_mask[o_g: o_g + sub.n_dofs].reshape(
                sub.n_scalar_dofs, bs)
        Dinv = _block_inverse(_diag_blocks(Ae_T, o, nds, bs),
                              sub.scalar_dofmap, sub.n_scalar_dofs, bs, fm,
                              sub)
        appliers.append((o_g, sub.n_dofs, bs, Dinv))

    def M(v):
        parts = []
        for o_g, n_sub, bs, Dinv in appliers:
            seg = v[o_g: o_g + n_sub].reshape(-1, bs)
            parts.append(torch.sum(Dinv * seg[:, None, :], dim=2).reshape(-1))
        return torch.cat(parts)

    return M


def block_jacobi_preconditioner(Ae_T, scalar_dofmap, n_scalar, bs,
                                free_mask=None, local_offset=0, n_dofs=None,
                                global_offset=0):
    """Node-block Jacobi for a (sub)space with `bs` interleaved components.

    Ae_T: lane-major element matrices over the FULL local dof vector of the
    form's space; scalar_dofmap: (nc, nd_scalar) scalar dofmap of the
    (sub)space; local_offset: where this sub's dofs start inside the
    element matrix; global_offset: where they start in the global vector.

    Returns M: full-length v -> v with this sub's segment block-solved and
    every other entry passed through unchanged."""
    scalar_dofmap = np.asarray(scalar_dofmap)
    nds = scalar_dofmap.shape[1]
    fm = None
    if free_mask is not None:
        fm = free_mask[global_offset: global_offset + n_scalar * bs].reshape(
            n_scalar, bs)
    Dinv = _block_inverse(_diag_blocks(Ae_T, local_offset, nds, bs),
                          scalar_dofmap, n_scalar, bs, fm,
                          SimpleNamespace(_index_cache={}))
    seg_len = n_scalar * bs

    def M(v):
        seg = v[global_offset: global_offset + seg_len].reshape(n_scalar, bs)
        seg = torch.sum(Dinv * seg[:, None, :], dim=2).reshape(-1)
        return torch.cat([v[:global_offset], seg,
                          v[global_offset + seg_len:]])

    return M
