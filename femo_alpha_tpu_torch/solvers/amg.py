"""Nullspace-based aggregation AMG for unstructured meshes + penalty BCs.

Port of femo_alpha_tpu/solvers/amg.py. RMShellModel selects it where the
RCM band Cholesky (solvers/band.py) would pass its memory guard: penalty
BCs, or strong BCs on an unstructured mesh, at a few hundred thousand
dofs. As the reference says of itself, its aggregate rigid-body-mode
coarse space is weak for THIN shells (the low modes are inextensional
bending and local mechanisms, which piecewise rigid-body spaces cannot
approximate in the energy norm), so such shells take many CG iterations;
a spectral (GenEO-type) coarse space would be the cure. The port matches
the reference's method and parameters and records its iteration counts.

Design:
- Aggregation is host setup, geometry and topology only, once per model:
  greedy Vanek aggregation of mesh nodes on the cell-sharing graph, merged
  pairwise until the coarse space has at most max_coarse_dofs dofs; every
  scalar dof joins the aggregate of its nearest mesh node (scipy cKDTree).
  The code is the reference's, so the aggregates and the prolongator
  weights come out identical.
- The tentative prolongator holds the 6 rigid-body modes of the shell,
  QR-orthonormal per aggregate, unsmoothed: P is a gather and a 6-weight
  contraction, restriction its transpose, summed in a fixed order
  (spaces/fixed_order.py).
- Per design, `setup` builds the additive-Schwarz smoother
  (multigrid.schwarz_arrays: diagonal-corrected element blocks inverted in
  batch; its apply runs K1, cuda_kernels.cell_matvec_T, on the card), the
  Chebyshev lambda_max by CG-Lanczos from the reference's start vector,
  and the dense Galerkin coarse matrix A_c = P^T (f A f) P with its
  Jacobi-scaled inverse. The coarse assembly reduces within each cell
  first: the cell's local projector T_c (nd x 6m, m the number of
  distinct aggregates the cell touches, at most a few) gives the cell's
  coarse block T_c^T A_c T_c by batched matmuls in chunks of cells; the
  blocks' (aggregate pair, 6 x 6) entries are then summed across cells by
  a fixed-order plan built once per model on the host (its depth is the
  largest number of cells that share one aggregate pair, not the number
  of element-matrix entries behind a coarse entry).
- The fine operator is the fused constrained operator
  (constrained_matvec_T) applied to f*x, which is exactly f A (f x).
- `setup(..., dtype=torch.float32)` (AMGPrecondFactory(dtype=)) is the
  reference's f32 configuration: the state is set up in f32 (the Schwarz
  blocks, lmax over the f32 builds of K1 and the fused operator, the
  coarse inverse) and each apply runs in the vector's dtype on that state
  rounded to f32, upcast once per state.
- Penalty BCs are handled by an F/P split: the dofs the penalty facet
  operator touches (from its assembled diagonal) are masked out of the AMG
  and get an exact diagonal solve instead (PenaltySplitAMG,
  AMGPrecondFactory).

Everything per design runs without autograd and in f64.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..assembly.assemble import make_constrained_matvec_T
from ..spaces.fixed_order import (
    fixed_order_reduce,
    fixed_order_scatter,
    sum_plan,
)
from .multigrid import (
    apply_schwarz_T,
    chebyshev_smooth,
    estimate_lmax,
    schwarz_arrays_T,
)


# --------------------------------------------------------------------------
# host-side aggregation
# --------------------------------------------------------------------------


def node_adjacency(conn, n_nodes):
    """Node -> set(neighbor nodes) via shared cells (host, setup-only)."""
    adj = [set() for _ in range(n_nodes)]
    conn = np.asarray(conn)
    for cell in conn:
        for a in cell:
            adj[a].update(int(x) for x in cell if x != a)
    return adj


def aggregate_nodes(conn, n_nodes, max_aggregates=None, rounds=0):
    """Greedy Vanek aggregation of mesh nodes; returns ((n_nodes,) aggregate
    ids, number of aggregates).

    Phase 1: nodes whose neighborhood is fully unaggregated seed a new
    aggregate from that neighborhood. Phase 2: leftovers join the most
    popular neighboring aggregate. `rounds` extra pairwise-merge sweeps on
    the aggregate graph coarsen further (each halves the count, roughly);
    with `max_aggregates` set, merging continues until under the cap.
    """
    adj = node_adjacency(conn, n_nodes)
    agg = -np.ones(n_nodes, dtype=np.int64)
    na = 0
    for v in range(n_nodes):
        if agg[v] != -1:
            continue
        if all(agg[u] == -1 for u in adj[v]):
            agg[v] = na
            for u in adj[v]:
                agg[u] = na
            na += 1
    for v in range(n_nodes):
        if agg[v] != -1:
            continue
        counts = {}
        for u in adj[v]:
            if agg[u] != -1:
                counts[agg[u]] = counts.get(agg[u], 0) + 1
        if counts:
            agg[v] = max(counts, key=counts.get)
        else:  # isolated node
            agg[v] = na
            na += 1

    def merge_pass(agg, na):
        aadj = [set() for _ in range(na)]
        for v in range(n_nodes):
            for u in adj[v]:
                if agg[u] != agg[v]:
                    aadj[agg[v]].add(int(agg[u]))
        matched = -np.ones(na, dtype=np.int64)
        new_id = 0
        for a in range(na):
            if matched[a] != -1:
                continue
            partner = -1
            for b in aadj[a]:
                if matched[b] == -1:
                    partner = b
                    break
            matched[a] = new_id
            if partner != -1:
                matched[partner] = new_id
            new_id += 1
        return matched[agg], new_id

    for _ in range(rounds):
        agg, na = merge_pass(agg, na)
    if max_aggregates is not None:
        while na > max_aggregates:
            agg, na_new = merge_pass(agg, na)
            if na_new == na:
                break
            na = na_new
    return agg, na


def shell_nullspace(W, kinds, dof_coords_list, center=None):
    """Rigid-body modes B (n_dofs, 6) for a mixed shell space (numpy).

    kinds: per-subspace 'disp' (modes: translations + r x (x-c)) or 'rot'
    (modes: 0 + constant r) or 'scalar' (single constant mode in column 0).
    dof_coords_list: per-subspace (n_scalar, gdim) coordinates."""
    B = np.zeros((W.n_dofs, 6))
    if center is None:
        center = np.mean(np.concatenate(dof_coords_list, axis=0), axis=0)
    for i, sub in enumerate(W.subspaces):
        o = int(W.offsets[i])
        vs = sub.value_size
        x = np.asarray(dof_coords_list[i], dtype=np.float64)
        if x.shape[1] < 3:
            x = np.concatenate(
                [x, np.zeros((len(x), 3 - x.shape[1]))], axis=1)
        ns = sub.n_scalar_dofs
        if kinds[i] == "disp":
            assert vs == 3
            d = x - center[None, :3]
            for k in range(3):  # translations
                B[o + k: o + 3 * ns: 3, k] = 1.0
            # rotations r_k x d (r = e_k): rows are the 3 components per node
            rx = np.zeros((ns, 3, 3))
            rx[:, 0, 1] = -d[:, 2]
            rx[:, 0, 2] = d[:, 1]
            rx[:, 1, 0] = d[:, 2]
            rx[:, 1, 2] = -d[:, 0]
            rx[:, 2, 0] = -d[:, 1]
            rx[:, 2, 1] = d[:, 0]
            B[o: o + 3 * ns, 3:6] = rx.reshape(3 * ns, 3)
        elif kinds[i] == "rot":
            assert vs == 3
            for k in range(3):
                B[o + k: o + 3 * ns: 3, 3 + k] = 1.0
        else:  # scalar
            B[o: o + sub.n_dofs, 0] = 1.0
    return B


# --------------------------------------------------------------------------
# the preconditioner
# --------------------------------------------------------------------------


class AggregationAMG:
    """Two-level nullspace aggregation AMG preconditioner (CG-symmetric).

    The smoother is the weighted additive Schwarz (the reference's
    default; its block-Jacobi option has no caller and is not ported).
    Static structure (aggregation, prolongator weights, the coarse
    assembly's plan) is host setup, moved to a device at first use there;
    per-design state (Schwarz blocks, lambda_max, dense coarse inverse) is
    the dict `setup` returns. Element matrices are lane-major
    (nd, nd, nc), as everywhere on the port's solve path."""

    def __init__(self, space, kinds=None, free_mask=None, agg_rounds=1,
                 max_coarse_dofs=4800, degree=3, lmin_ratio=0.3,
                 power_iters=20, chunk_cells=512):
        from scipy.spatial import cKDTree

        t0 = time.perf_counter()
        W = space
        if not hasattr(W, "subspaces"):
            raise TypeError("AggregationAMG expects a MixedSpace")
        mesh = W.subspaces[0].mesh
        if kinds is None:
            kinds = ["disp"] + ["rot"] * (len(W.subspaces) - 1)
        self.space = W
        self.degree = degree
        self.lmin_ratio = lmin_ratio
        self.power_iters = power_iters
        self.chunk_cells = chunk_cells

        max_aggs = max(1, max_coarse_dofs // 6)
        agg_nodes, na = aggregate_nodes(
            mesh.conn, mesh.n_nodes, max_aggregates=max_aggs,
            rounds=agg_rounds)
        self.n_agg = int(na)
        self.nc_dofs = 6 * self.n_agg

        # scalar dof -> aggregate (nearest mesh node: exact for vertex dofs,
        # an endpoint of the containing edge for CG2 edge/cell dofs)
        tree = cKDTree(np.asarray(mesh.coords))
        dof_coords = []
        agg_per_dof = np.empty(W.n_dofs, dtype=np.int64)
        for i, sub in enumerate(W.subspaces):
            xc = np.asarray(sub.dof_coords)
            dof_coords.append(xc)
            _, nearest = tree.query(xc)
            o = int(W.offsets[i])
            agg_per_dof[o: o + sub.n_dofs] = np.repeat(agg_nodes[nearest],
                                                       sub.value_size)
        B = shell_nullspace(W, kinds, dof_coords)
        free_np = (np.ones(W.n_dofs) if free_mask is None
                   else np.asarray(free_mask, dtype=np.float64))
        B = B * free_np[:, None]  # constrained dofs carry no coarse modes

        # per-aggregate QR of the nullspace rows -> tentative prolongator
        # weights w (n_dofs, 6); rank-deficient columns zeroed (guarded by
        # an identity coarse diagonal later)
        order = np.argsort(agg_per_dof, kind="stable")
        bounds = np.searchsorted(agg_per_dof[order],
                                 np.arange(self.n_agg + 1))
        w = np.zeros((W.n_dofs, 6))
        for a in range(self.n_agg):
            rows = order[bounds[a]: bounds[a + 1]]
            if len(rows) == 0:
                continue
            q, r = np.linalg.qr(B[rows])
            keep = np.abs(np.diagonal(r)) > 1e-10 * max(
                1.0, np.abs(r).max())
            w[rows] = q * keep[None, :]
        self.free_np = free_np
        self.agg = agg_per_dof
        self.w = w
        self._index_cache = {}
        self._coarse_host = {}
        self.cells = None  # spaces.CellRange under a cell split
        # aggregation, nullspace and QR, host seconds
        self.host_setup_s = time.perf_counter() - t0

    def shard(self, cells):
        """Set up from one rank's cells from now on (a spaces.CellRange;
        parallel/product.py): the Schwarz blocks and the operator over
        them, the assembled diagonal and the coarse Galerkin matrix summed
        over the ranks; aggregation, transfers and the coarse inverse
        replicated."""
        self.cells = cells

    def _W(self):
        """The space the per-cell setup and apply run on: the whole space,
        or this rank's cells of it."""
        return self.space if self.cells is None else self.cells

    # ------------------------------------------------------------ tables
    def _tables(self, device):
        """(agg (n,) int64, w_T (6, n) f64, free (n,) f64) on `device`."""
        key = ("tables", str(device))
        t = self._index_cache.get(key)
        if t is None:
            t = self._index_cache[key] = (
                torch.as_tensor(self.agg, device=device),
                torch.as_tensor(np.ascontiguousarray(self.w.T),
                                device=device),
                torch.as_tensor(self.free_np, device=device))
        return t

    def _coarse_plan_host(self):
        """Host part of the coarse assembly's plan (once per model): each
        cell's distinct aggregates, the position of each local dof's
        aggregate among them, and the (aggregate pair) target of each valid
        (cell, p, q) block."""
        W = self._W()
        rng = getattr(W, "cells", None)
        if rng not in self._coarse_host:
            G = self.agg[np.asarray(W.dofmap, dtype=np.int64)]
            nc, nd = G.shape
            order = np.argsort(G, axis=1, kind="stable")
            Gs = np.take_along_axis(G, order, axis=1)
            new = np.ones_like(Gs, dtype=bool)
            new[:, 1:] = Gs[:, 1:] != Gs[:, :-1]
            rank = np.cumsum(new, axis=1) - 1
            m = int(rank.max()) + 1
            pos = np.empty_like(rank)
            np.put_along_axis(pos, order, rank, axis=1)
            L = -np.ones((nc, m), dtype=np.int64)
            rows = np.repeat(np.arange(nc), nd)
            L[rows, rank.reshape(-1)] = Gs.reshape(-1)
            valid = (L[:, :, None] >= 0) & (L[:, None, :] >= 0)  # (nc,m,m)
            target = L[:, :, None] * self.n_agg + L[:, None, :]
            valid_idx = np.nonzero(valid.reshape(-1))[0]
            self._coarse_host[rng] = (m, pos, valid_idx,
                                      target.reshape(-1)[valid_idx])
        return self._coarse_host[rng]

    def _coarse_tables(self, device, dtype):
        W = self._W()
        rng = getattr(W, "cells", None)
        key = ("coarse_tables", str(device), dtype, rng)
        t = self._index_cache.get(key)
        if t is None:
            m, pos, valid_idx, target = self._coarse_plan_host()
            onehot = (pos[:, :, None] == np.arange(m)[None, None, :])
            t = self._index_cache[key] = (
                m, torch.as_tensor(onehot, dtype=dtype, device=device),
                torch.as_tensor(valid_idx, device=device),
                torch.as_tensor(np.asarray(W.dofmap, dtype=np.int64),
                                device=device))
        plan = sum_plan(self, ("coarse", rng), self._coarse_plan_host()[3],
                        device)
        return t + (plan,)

    # --------------------------------------------------------------- P ops
    def prolong(self, xc):
        """xc (6 NA,) -> fine (n_dofs,)."""
        agg, w_T, _ = self._tables(xc.device)
        return (w_T * xc.reshape(6, self.n_agg)[:, agg]).sum(0)

    def restrict(self, r):
        """fine (n_dofs,) -> (6 NA,), mode-major (k NA + I), the exact
        transpose of prolong; each aggregate sums its dofs in a fixed
        order."""
        _, w_T, _ = self._tables(r.device)
        plan = sum_plan(self, "restrict", self.agg, r.device)
        return fixed_order_reduce(w_T * r[None, :], plan, self.n_agg,
                                  dim=1).reshape(-1)

    # -------------------------------------------------------------- setup
    def _coarse_dense(self, Ae_T, free):
        """A_c = P^T (f A f) P as a dense (6 NA, 6 NA) tensor from lane-major
        element matrices (nd, nd, nc): per chunk of cells the cell blocks
        T_c^T A_c T_c (T_c: the cell's nd x 6m projector onto its m
        aggregates' modes, with the mask folded in), then one fixed-order
        sum of the (aggregate pair, 6 x 6) blocks across cells."""
        nd, _, nc = Ae_T.shape
        NA = self.n_agg
        m, onehot, valid_idx, dm, plan = self._coarse_tables(Ae_T.device,
                                                             Ae_T.dtype)
        _, w_T, _ = self._tables(Ae_T.device)
        fw = (free[None, :] * w_T.to(Ae_T.dtype)).T  # (n, 6)
        C = Ae_T.new_empty((nc, m, m, 6, 6))
        for s in range(0, nc, self.chunk_cells):
            e = min(s + self.chunk_cells, nc)
            T = (onehot[s:e, :, :, None] * fw[dm[s:e]][:, :, None, :]
                 ).reshape(e - s, nd, 6 * m)
            A = Ae_T[:, :, s:e].permute(2, 0, 1)
            Cc = T.transpose(1, 2) @ (A @ T)  # (chunk, 6m, 6m): (p,k),(q,l)
            C[s:e] = Cc.reshape(e - s, m, 6, m, 6).permute(0, 1, 3, 2, 4)
        vals = C.reshape(nc * m * m, 36)[valid_idx]
        Ac = fixed_order_reduce(vals, plan, NA * NA)
        if self.cells is not None:
            self.cells.comm.all_reduce(Ac)  # one rank's cells: the sum
        # coarse dof order is mode-major (k NA + I), matching
        # prolong/restrict: entry (k NA + I, l NA + J) = Ac[I, J, k, l]
        Ac = Ac.reshape(NA, NA, 6, 6).permute(2, 0, 3, 1).reshape(
            6 * NA, 6 * NA)
        # guard empty / rank-deficient coarse dofs
        d = torch.diagonal(Ac)
        return Ac + torch.diag((d == 0.0).to(Ac.dtype))

    def setup(self, Ae_T, free_mask=None, dtype=None):
        """Per-design state from lane-major element matrices (nd, nd, nc);
        free_mask overrides the constructor mask (e.g. with the penalty
        dofs masked as well). dtype: cast Ae_T first, so that the state is
        set up in that precision (f32: the Schwarz blocks, lmax over the
        f32 kernel builds, the coarse inverse); `apply` still runs in the
        vector's dtype, on the state rounded to `dtype`."""
        with torch.no_grad():
            Ae_T = Ae_T.detach()
            if dtype is not None:
                Ae_T = Ae_T.to(dtype)
            Ae_T = Ae_T.contiguous()
            dev, dtype = Ae_T.device, Ae_T.dtype
            free = (self._tables(dev)[2] if free_mask is None
                    else free_mask).to(dtype).contiguous()
            W = self._W()
            sm = self._smoother_arrays(Ae_T, free)
            mv = _masked_matvec(Ae_T, W, free)
            lmax = estimate_lmax(
                mv, lambda v: self._smooth_apply(sm, v), int(W.n_dofs),
                dtype, dev, iters=self.power_iters)
            Ac = self._coarse_dense(Ae_T, free)
            s = 1.0 / torch.sqrt(torch.abs(torch.diagonal(Ac)))
            coarse_inv = torch.linalg.inv(Ac * s[:, None] * s[None, :])
        return {"Ae": Ae_T, "matvec": mv, "sm": sm, "lmax": lmax,
                "free": free, "coarse_inv": coarse_inv, "coarse_scale": s}

    def _smoother_arrays(self, Ae_T, free):
        return schwarz_arrays_T(Ae_T, self._W(), free)

    def _smooth_apply(self, sm, v):
        return apply_schwarz_T(self._W(), sm[0], sm[1], v)

    # -------------------------------------------------------------- apply
    def _state_in(self, state, dtype):
        """The state's arrays in `dtype` (the vector's): the state itself,
        or its upcast made once per state and kept in it, as the JAX
        package's apply casts the f32 state to the vector's dtype."""
        if state["Ae"].dtype == dtype:
            return state
        cast = state.setdefault("_as", {})
        if dtype not in cast:
            with torch.no_grad():
                free = state["free"].to(dtype)
                cast[dtype] = {
                    "free": free,
                    "matvec": _masked_matvec(state["Ae"].to(dtype),
                                             self._W(), free),
                    "sm": tuple(a.to(dtype) for a in state["sm"]),
                    "lmax": state["lmax"].to(dtype),
                    "coarse_inv": state["coarse_inv"].to(dtype),
                    "coarse_scale": state["coarse_scale"].to(dtype)}
        return cast[dtype]

    def apply(self, state, b):
        """One 2-level cycle from zero guess: the M^{-1} of PCG, in b's
        dtype."""
        state = self._state_in(state, b.dtype)
        free = state["free"]
        b = free * b
        mv, sm, lmax = state["matvec"], state["sm"], state["lmax"]

        def Minv(v):
            return self._smooth_apply(sm, v)

        x = chebyshev_smooth(mv, Minv, lmax, b, torch.zeros_like(b),
                             degree=self.degree, lmin_ratio=self.lmin_ratio)
        r_c = self.restrict(b - mv(x))
        s = state["coarse_scale"]
        e_c = s * (state["coarse_inv"] @ (s * r_c))
        x = x + free * self.prolong(e_c)
        return chebyshev_smooth(mv, Minv, lmax, b, x, degree=self.degree,
                                lmin_ratio=self.lmin_ratio)


def _masked_matvec(Ae_T, W, free):
    """x -> f A (f x): the fused constrained operator applied to f*x (its
    identity term (1-f) f x is exactly zero)."""
    op = make_constrained_matvec_T(Ae_T, W, free)

    def mv(x):
        return op(free * x)

    return mv


# --------------------------------------------------------------------------
# penalty split
# --------------------------------------------------------------------------


def penalty_split(facet_ops, n_dofs, rel_tol=1e-10):
    """Penalty-dominated dofs, detected algebraically from the facet
    operators' assembled diagonal (lane-major blocks (nd, nd, n_facets)
    with their op specs, summed in a fixed order). Returns (pen_mask (n,),
    1.0 on the dofs the penalty touches, pen_diag (n,))."""
    pen_diag = None
    for Ae_f, spec in facet_ops:
        dg = torch.diagonal(Ae_f, dim1=0, dim2=1)  # (n_facets, nd)
        if hasattr(spec, "scatter_add"):
            d = spec.scatter_add(dg)
        else:
            plan = sum_plan(spec, "scatter", spec.dofmap, dg.device)
            d = fixed_order_scatter(dg.reshape(-1), plan, n_dofs)
        pen_diag = d if pen_diag is None else pen_diag + d
    pen_mask = (pen_diag > rel_tol * torch.max(pen_diag)).to(pen_diag.dtype)
    return pen_mask, pen_diag


def _split_state(amg, cell_Ae_T, facet_ops, free, dtype=None):
    """The penalty split's state: the AMG on free AND not penalized (set up
    in `dtype`), the inverse diagonal (elastic + penalty, so penalty rows
    see their full row scale) on the penalized free dofs, the identity on
    constrained ones."""
    with torch.no_grad():
        n = amg.space.n_dofs
        kw = dict(dtype=cell_Ae_T.dtype, device=cell_Ae_T.device)
        if facet_ops:
            pen_mask, pen_diag = penalty_split(facet_ops, n)
        else:
            pen_mask = torch.zeros(n, **kw)
            pen_diag = torch.zeros(n, **kw)
        free = torch.as_tensor(free, **kw)
        st = amg.setup(cell_Ae_T, free_mask=free * (1.0 - pen_mask),
                       dtype=dtype)
        diag = amg._W().scatter_add(
            torch.diagonal(cell_Ae_T, dim1=0, dim2=1))
        diag_full = (diag + pen_diag) * free + (1.0 - free)
        safe = torch.where(diag_full != 0.0, diag_full,
                           torch.ones_like(diag_full))
        pm = pen_mask * free
        return {"amg": st, "pen_mask": pm, "pen_inv": pm / safe,
                "dead": 1.0 - free}


def _split_apply(amg, state, v):
    pm = state["pen_mask"]
    y = amg.apply(state["amg"], (1.0 - pm) * v)
    return (1.0 - pm) * y + state["pen_inv"] * v + state["dead"] * v


class PenaltySplitAMG:
    """M^{-1} = the AMG on the penalty-masked elastic block (+) an exact
    diagonal solve on the penalty block: symmetric PSD, valid for CG.
    After diagonal scaling the penalty rows form a well-conditioned facet
    mass system, coupled to the elastic block by O(sqrt(elastic/beta));
    the AMG treats penalized dofs exactly like strong-BC dofs."""

    def __init__(self, amg: AggregationAMG, state):
        self.amg = amg
        self.state = state

    def __call__(self, v):
        return _split_apply(self.amg, self.state, v)


def build_penalty_split_precond(amg, cell_Ae_T, facet_ops, free_mask):
    """One-call construction from lane-major cell element matrices and
    (lane-major facet block, op spec) pairs."""
    return PenaltySplitAMG(amg, _split_state(amg, cell_Ae_T, facet_ops,
                                             free_mask))


class AMGPrecondFactory:
    """Split-protocol preconditioner (adjoint/implicit.py, the contract of
    solvers.band.BandPrecond): the two-level aggregation AMG on the elastic
    block + the exact diagonal on the penalty block. Selected by
    RMShellModel where the band Cholesky passes its memory guard. The
    forward solve's state is reused by the adjoint solve. dtype: the AMG's
    setup precision (None: the operator's; torch.float32: the JAX
    package's TPU configuration, applied in the vector's dtype); the
    model's AMG route stays f64, as the JAX package's does off the TPU."""

    def __init__(self, space, form, facet_forms=(), free_mask=None,
                 dtype=None, **amg_kw):
        self.amg = AggregationAMG(form.space, free_mask=free_mask, **amg_kw)
        n = form.space.n_dofs
        self.dtype = dtype
        self.free_mask = (np.ones(n) if free_mask is None
                          else np.asarray(free_mask, dtype=np.float64))
        # the op layout of ImplicitPDE._assemble_ops: the cell block, then
        # one block per facet form that has facets
        self._specs = [form.space] + [ff.block for ff in facet_forms
                                      if ff.groups]

    def prepare(self, params, grad_keys=frozenset()):
        return ()

    def shard_state(self, spec):
        """Set the AMG up from this rank's cells of the cell block
        (AggregationAMG.shard); the penalty split's facet blocks stay
        replicated."""
        self.amg.shard(spec.cells_of(self._specs[0]))

    def setup_state(self, u, params, ops_Ae, aux):
        return _split_state(self.amg, ops_Ae[0],
                            list(zip(ops_Ae[1:], self._specs[1:])),
                            self.free_mask, dtype=self.dtype)

    def apply_state(self, state, v):
        return _split_apply(self.amg, state, v)
