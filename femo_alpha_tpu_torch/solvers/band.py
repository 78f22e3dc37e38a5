"""Blocked band Cholesky: the direct solver of unstructured shell meshes and
penalty BCs (the role MUMPS plays in the reference FEMO).

Port of femo_alpha_tpu/solvers/band.py, in f64 on the card by default:

- Shell meshes are 2D manifolds: after reverse Cuthill-McKee the stiffness
  matrix has half bandwidth b = O(sqrt(N)), so block-band storage
  R[t, r, c] = A[t*w + r, (t-m)*w + c] (lower triangle, K = (m+1)*w,
  m = ceil(b/w)) fits where dense (N, N) cannot.
- The factorization walks the nb block columns with a (K, K) trailing
  window: Cholesky of the w x w diagonal block, a triangular solve for the
  (m*w, w) panel below it and the rank-w update of the window, N*b^2 flops
  in all. Only the lower triangle of the window is ever read, so the band's
  lower storage is used as it is. The window shifts between two buffers
  made once; the diagonal factors go through `cholesky_ex` with no host
  check, and their `info` is checked once, after the loop: an f64 factor
  that fails raises, it is never shifted or retried.
- The system is equilibrated to unit diagonal first (this absorbs the
  beta = 1e15 penalty scale), so the f64 factor is a direct solve and the
  CG around it converges in one or two iterations.
- The band is assembled from the element blocks in a fixed order: every
  band slot sums its element entries in an order fixed per mesh (a padded
  inverse table made once on the host, as for the fused operator), so two
  assemblies, and two factors, of the same system are bit-identical. A
  `segment_sum`/`index_add_` here would add with atomics on the card.

`BandCholPrecond(dtype=torch.float32, shift=1e-5)` is the reference's f32
configuration (its TPU default, selectable on the CPU): the band is
assembled and equilibrated in f64, then factored and solved in f32, and
the solve's vectors are cast to f32 and back. Its breakdown guard: where
the f32 factor fails (`cholesky_ex` reports it in `info`, where XLA gives
NaNs) or is not finite, it refactors once with `shift` added to the
equilibrated diagonal; if that factor fails too, it raises (the reference
carries the NaNs on). The state records whether the shift was taken. The
default stays f64. The factor and solves are plain PyTorch (`cholesky_ex`,
`solve_triangular`, `addmm`); the reference ran them as plain XLA too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..native import rcm_order

# --------------------------------------------------------------------------
# host setup: permutation, bandwidth, assembly plan
# --------------------------------------------------------------------------


def nodal_dof_permutation(space):
    """RCM-ordered, node-grouped scalar-dof permutation for a (Mixed)Space.

    Every scalar dof (any subspace, CG2 edge dofs included) is assigned to
    its nearest mesh node; dofs are ordered by the RCM position of that
    node, then by subspace, so displacement and rotation dofs of the same
    region interleave. Returns (perm, iperm): perm[new] = old,
    iperm[old] = new."""
    from scipy.spatial import cKDTree

    mesh = space.mesh
    mesh._build_topology()
    node_perm = rcm_order(mesh.edges, mesh.n_nodes)
    pos = np.empty(mesh.n_nodes, dtype=np.int64)
    pos[node_perm] = np.arange(mesh.n_nodes)

    tree = cKDTree(np.asarray(mesh.coords))
    subspaces = getattr(space, "subspaces", [space])
    offsets = getattr(space, "offsets", [0])
    keys_pos = np.empty(space.n_dofs, dtype=np.int64)
    keys_sub = np.empty(space.n_dofs, dtype=np.int64)
    for i, sub in enumerate(subspaces):
        _, nearest = tree.query(np.asarray(sub.dof_coords))
        o = int(offsets[i])
        keys_pos[o: o + sub.n_dofs] = np.repeat(pos[nearest], sub.value_size)
        keys_sub[o: o + sub.n_dofs] = i
    order_within = np.arange(space.n_dofs)
    perm = np.lexsort((order_within, keys_sub, keys_pos))
    iperm = np.empty(space.n_dofs, dtype=np.int64)
    iperm[perm] = np.arange(space.n_dofs)
    return perm.astype(np.int32), iperm.astype(np.int32)


def permuted_bandwidth(iperm, dofmaps):
    """Half bandwidth of the permuted assembled matrix."""
    b = 0
    for dm in dofmaps:
        p = iperm[np.asarray(dm)]
        b = max(b, int((p.max(axis=1) - p.min(axis=1)).max()))
    return b


def pick_block(b, n):
    """Factor block width: wide for the matrix units, small enough that the
    (m+1)w window stays close to the true bandwidth."""
    w = 128 if b >= 384 else (64 if b >= 96 else 32)
    return min(w, max(32, n))


def band_assembly_plan(dofmaps, iperm, n, w, m, free=None):
    """Where each element entry goes in the block-band storage, as a fixed
    summation order.

    dofmaps: the (nc_k, nd) dofmap of each element block, in the order of
    the blocks whose lane-major matrices (nd, nd, nc_k) will be assembled;
    their flat entries, block after block, form one source vector. free:
    optional 0/1 mask (original dof order) — entries in a constrained row or
    column are dropped. Returns (slots (S,), inv (S, c)): band slot s (flat
    index into (nb, w, K)) is the sum of the sources inv[s, 0..c-1], in
    that order (the sources' own order); padding points one past the
    sources (to a zero)."""
    K = (m + 1) * w
    slot_parts, src_parts = [], []
    offset = 0
    for dm in dofmaps:
        dm = np.asarray(dm, dtype=np.int64)
        nc, nd = dm.shape
        p = np.asarray(iperm, dtype=np.int64)[dm].T  # (nd, nc)
        I = np.broadcast_to(p[:, None, :], (nd, nd, nc))  # row of (i,j,c)
        J = np.broadcast_to(p[None, :, :], (nd, nd, nc))
        keep = I >= J
        if free is not None:
            f = np.asarray(free)[dm].T > 0
            keep &= f[:, None, :] & f[None, :, :]
        src = np.flatnonzero(keep)
        i, j = I.reshape(-1)[src], J.reshape(-1)[src]
        t = i // w
        slot_parts.append(t * (w * K) + (i - t * w) * K + (j - (t - m) * w))
        src_parts.append(src + offset)
        offset += nd * nd * nc
    slots = np.concatenate(slot_parts)
    src = np.concatenate(src_parts)
    order = np.lexsort((src, slots))
    slots, src = slots[order], src[order]
    uniq, starts, counts = np.unique(slots, return_index=True,
                                     return_counts=True)
    inv = np.full((len(uniq), int(counts.max())), offset, dtype=np.int64)
    rank = np.arange(len(slots)) - np.repeat(starts, counts)
    inv[np.repeat(np.arange(len(uniq)), counts), rank] = src
    return uniq, inv


# --------------------------------------------------------------------------
# device: assembly, equilibration, factorization, solves
# --------------------------------------------------------------------------


def assemble_block_band(ops, slots, inv, diag_fill, nb, w, K):
    """Block-band lower storage R (nb, w, K) in f64 from the lane-major
    element blocks `ops` and the plan of `band_assembly_plan` (on the ops'
    device); `diag_fill` lists the flat slots of the unit diagonal given to
    constrained and padding rows."""
    src = torch.cat([Ae.reshape(-1).to(torch.float64) for Ae in ops]
                    + [ops[0].new_zeros(1, dtype=torch.float64)])
    vals = src[inv[:, 0]]
    for k in range(1, inv.shape[1]):
        vals = vals + src[inv[:, k]]
    R = src.new_zeros(nb * w * K)
    R[slots] = vals
    R[diag_fill] = 1.0
    return R.reshape(nb, w, K)


def equilibrate(R, w, m):
    """Symmetric Jacobi equilibration to unit diagonal, in place: R becomes
    S A S with s = 1/sqrt(diag). Returns s (n_pad,)."""
    nb, _, K = R.shape
    r = torch.arange(w, device=R.device)
    d = R[:, r, m * w + r]  # (nb, w)
    s = 1.0 / torch.sqrt(torch.where(d > 0, d, torch.ones_like(d)))
    sflat = s.reshape(-1)
    n_pad = nb * w
    col_j = ((torch.arange(nb, device=R.device) - m)[:, None] * w
             + torch.arange(K, device=R.device)[None, :])
    inside = (col_j >= 0) & (col_j < n_pad)
    col_s = torch.where(inside, sflat[col_j.clamp(0, n_pad - 1)],
                        torch.ones((), dtype=R.dtype, device=R.device))
    R.mul_(s[:, :, None]).mul_(col_s[:, None, :])
    return sflat


def band_cholesky(R, w, m):
    """Blocked band Cholesky of the block-band lower storage R (nb, w, K).

    Returns (Ld (nb, w, w) diagonal-block factors, Lc (nb, m*w, w) column
    panels below them): A = L L^T with L[tw:(t+1)w, tw:(t+1)w] = Ld[t] and
    L[(t+1)w:(t+1+m)w, tw:(t+1)w] = Lc[t]. Raises if a diagonal block is
    not positive definite."""
    Ld, Lc, info = band_cholesky_ex(R, w, m)
    bad = torch.nonzero(info).flatten()
    if bad.numel():
        t = int(bad[0])
        raise RuntimeError(
            f"band_cholesky: block {t} of {Ld.shape[0]} is not positive "
            f"definite (info {int(info[t])}): the assembled system is not "
            "SPD")
    return Ld, Lc


def band_cholesky_ex(R, w, m):
    """band_cholesky without the check: (Ld, Lc, info), info (nb,) the
    `cholesky_ex` info of each diagonal block (0 where it succeeded)."""
    nb, _, K = R.shape
    mw = m * w
    kw = dict(dtype=R.dtype, device=R.device)
    win, nxt = torch.zeros((K, K), **kw), torch.zeros((K, K), **kw)
    for t in range(min(m + 1, nb)):
        win[t * w:(t + 1) * w, :(t + 1) * w] = R[t][:, (m - t) * w:]
    for t in range(nb, m + 1):  # tiny problems: identity past the end
        win[t * w:(t + 1) * w, t * w:(t + 1) * w] = torch.eye(w, **kw)
    past_end = torch.zeros((w, K), **kw)
    past_end[:, mw:] = torch.eye(w, **kw)
    Ld = torch.empty((nb, w, w), **kw)
    Lc = torch.empty((nb, mw, w), **kw)
    info = torch.empty(nb, dtype=torch.int32, device=R.device)
    for t in range(nb):
        torch.linalg.cholesky_ex(win[:w, :w], check_errors=False,
                                 out=(Ld[t], info[t]))
        # the panel below: Lc Ld^T = W[w:, :w]
        torch.linalg.solve_triangular(Ld[t].mT, win[w:, :w], upper=True,
                                      left=False, out=Lc[t])
        # the trailing window, shifted up-left by one block
        torch.addmm(win[w:, w:], Lc[t], Lc[t].mT, alpha=-1.0,
                    out=nxt[:mw, :mw])
        nxt[mw:] = R[t + m + 1] if t + m + 1 < nb else past_end
        win, nxt = nxt, win
    return Ld, Lc, info


def band_solve(Ld, Lc, b):
    """Solve L L^T x = b with the band_cholesky factors; b: (n_pad,).
    Forward and backward substitution over the block rows, the panel
    products accumulated into a buffer that reaches m*w past the end."""
    nb, w, _ = Ld.shape
    mw = Lc.shape[1]
    n_pad = nb * w
    acc = b.new_zeros(n_pad + mw)
    acc[:n_pad] = b
    y = b.new_empty(n_pad)
    for t in range(nb):
        s = t * w
        torch.linalg.solve_triangular(Ld[t], acc[s:s + w, None], upper=False,
                                      out=y[s:s + w, None])
        acc[s + w:s + w + mw].addmv_(Lc[t], y[s:s + w], alpha=-1.0)
    x = b.new_zeros(n_pad + mw)
    for t in range(nb - 1, -1, -1):
        s = t * w
        y[s:s + w].addmv_(Lc[t].mT, x[s + w:s + w + mw], alpha=-1.0)
        torch.linalg.solve_triangular(Ld[t].mT, y[s:s + w, None], upper=True,
                                      out=x[s:s + w, None])
    return x[:n_pad]


# --------------------------------------------------------------------------
# the preconditioner objects
# --------------------------------------------------------------------------


class BandCholPrecond:
    """Static structure (permutation, bandwidth, block sizes, assembly plan)
    computed once on the host per space and element-block layout;
    `setup(ops)` assembles, equilibrates and factors on the ops' device;
    `apply` solves.

    dofmaps: the dofmap of each element block, in the order `setup` gets
    their lane-major matrices; dtype: the factor's precision (None or
    torch.float64: f64; torch.float32: the f32 factor with its shift
    guard, see the module docstring); shift: that guard's diagonal shift;
    free: optional strong-BC 0/1 mask over the original dof order (numpy
    or tensor)."""

    def __init__(self, space, dofmaps, dtype=None, shift=1e-5, free=None):
        if dtype not in (None, torch.float64, torch.float32):
            raise TypeError(f"BandCholPrecond: dtype {dtype} "
                            "(float32/float64)")
        self.dtype = dtype or torch.float64
        self.shift = shift
        self.n = space.n_dofs
        self.perm, self.iperm = nodal_dof_permutation(space)
        self.b = permuted_bandwidth(self.iperm, dofmaps)
        self.w = pick_block(self.b, self.n)
        self.m = max(1, -(-self.b // self.w))
        self.nb = -(-self.n // self.w)
        self.n_pad = self.nb * self.w
        self.K = (self.m + 1) * self.w
        if free is not None:
            free = np.asarray(torch.as_tensor(free).cpu(), dtype=np.float64)
        self._dofmaps, self._free = [np.asarray(d) for d in dofmaps], free
        self._tables = {}
        self.cells = None  # spaces.CellRange of the first block, split

    def shard(self, cells):
        """Assemble the first (cell) block from one rank's cells from now
        on (a spaces.CellRange; parallel/product.py): the rank's entries,
        one all_reduce of the band, then the replicated blocks and the
        unit diagonal of dead rows. The factor and solves are
        replicated."""
        self.cells = cells

    def mem_bytes_reference(self):
        """The reference's memory estimate of this band (its guard): f64
        assembly plus an f32 factor, 12 bytes per band entry."""
        return self.n_pad * (self.m + 1) * self.w * 12

    def tables(self, device):
        """The device tables (perm, iperm, slots, inv, diag_fill), built
        once per device."""
        key = str(device)
        tab = self._tables.get(key)
        if tab is None:
            slots, inv = band_assembly_plan(self._dofmaps, self.iperm,
                                            self.n, self.w, self.m,
                                            free=self._free)
            tab = self._tables[key] = tuple(
                torch.as_tensor(a, dtype=torch.int64, device=device)
                for a in (self.perm, self.iperm, slots, inv,
                          self._dead_fill()))
        return tab

    def _dead_fill(self):
        """The flat band slots of the unit diagonal of the constrained and
        padding rows."""
        rows = np.arange(self.n_pad)
        dead = rows >= self.n
        if self._free is not None:
            fperm = np.ones(self.n_pad)
            fperm[:self.n] = self._free[self.perm]
            dead |= fperm == 0
        dr = rows[dead]
        return (dr // self.w) * (self.w * self.K) + (dr % self.w) * \
            self.K + self.m * self.w + dr % self.w

    def assemble(self, ops):
        """The block-band storage (nb, w, K), f64, of the sum of the
        lane-major element blocks `ops` (in the order of `dofmaps`; under
        `shard` the first block holds one rank's cells)."""
        if self.cells is not None:
            return self._assemble_split(ops)
        _, _, slots, inv, fill = self.tables(ops[0].device)
        return assemble_block_band(ops, slots, inv, fill, self.nb, self.w,
                                   self.K)

    def _split_tables(self, device):
        """(cell slots, cell inv) over the rank's cells, without the unit
        diagonal, and (slots, inv) of the replicated blocks, or None."""
        key = ("split", str(device), self.cells.cells)
        tab = self._tables.get(key)
        if tab is None:
            def plan(dms):
                return tuple(torch.as_tensor(a, dtype=torch.int64,
                                             device=device)
                             for a in band_assembly_plan(
                                 dms, self.iperm, self.n, self.w, self.m,
                                 free=self._free))
            rest = plan(self._dofmaps[1:]) if len(self._dofmaps) > 1 \
                else None
            fill = torch.as_tensor(self._dead_fill(), dtype=torch.int64,
                                   device=device)
            tab = self._tables[key] = (plan([self.cells.dofmap]), rest, fill)
        return tab

    def _assemble_split(self, ops):
        (sc, ic), rest, fill = self._split_tables(ops[0].device)
        R = assemble_block_band(ops[:1], sc, ic, fill[:0], self.nb, self.w,
                                self.K)
        self.cells.comm.all_reduce(R)
        if rest is None:
            R.view(-1)[fill] = 1.0
            return R
        return R + assemble_block_band(ops[1:], rest[0], rest[1], fill,
                                       self.nb, self.w, self.K)

    def permute_ops(self, ops):
        """[(Ae, spec)] element blocks -> [(Ae, the spec's dofmap in the
        permuted (RCM) dof order)]."""
        iperm = np.asarray(self.iperm, dtype=np.int64)
        return [(Ae, iperm[np.asarray(getattr(sp, "dofmap", sp))])
                for Ae, sp in ops]

    def factor(self, R):
        """Equilibrate R (f64) in place and factor it in `dtype`
        (band_factor): the state `apply` uses."""
        return band_factor(R, self.w, self.m, self.dtype, self.shift)

    def setup(self, ops):
        return self.factor(self.assemble(ops))

    def apply(self, state, v):
        """x = A^{-1} v through the equilibrated factor: S (LL^T)^{-1} S v,
        the triangular solves in the factor's dtype."""
        perm, iperm = self.tables(v.device)[:2]
        s = state["s"].to(v.dtype)
        vp = v.new_zeros(self.n_pad)
        vp[:self.n] = v[perm]
        Ld = state["Ld"]
        x = band_solve(Ld, state["Lc"], (vp * s).to(Ld.dtype))
        return (x.to(v.dtype) * s)[:self.n][iperm]


def band_factor(R, w, m, dtype=torch.float64, shift=1e-5):
    """Equilibrate the f64 block-band storage R in place and factor it in
    `dtype`: {"Ld", "Lc", "s", "shifted"}. An f64 factor that fails raises
    (band_cholesky). An f32 factor that fails or is not finite is taken
    again once with `shift` added to the equilibrated diagonal
    ("shifted": True); if that one fails too, it raises."""
    s = equilibrate(R, w, m)
    if dtype == torch.float64:
        Ld, Lc = band_cholesky(R, w, m)
        return {"Ld": Ld, "Lc": Lc, "s": s, "shifted": False}
    Rs = R.to(dtype)
    Ld, Lc, info = band_cholesky_ex(Rs, w, m)
    shifted = _failed(Ld, Lc, info)
    if shifted:
        r = torch.arange(w, device=Rs.device)
        Rs[:, r, m * w + r] += shift
        Ld, Lc, info = band_cholesky_ex(Rs, w, m)
        if _failed(Ld, Lc, info):
            raise RuntimeError(
                f"band_cholesky: the {dtype} factor failed, and again with "
                f"the diagonal shifted by {shift}")
    return {"Ld": Ld, "Lc": Lc, "s": s, "shifted": shifted}


def _failed(Ld, Lc, info):
    """Whether a factor failed: a block's info, or a non-finite entry (one
    host read)."""
    return bool(torch.any(info != 0)
                | ~torch.isfinite(Ld.sum() + Lc.sum()))


class BandPrecond:
    """Split-protocol preconditioner (adjoint/implicit.py): factors the band
    Cholesky of the current linearization once per forward solve, and the
    adjoint solve reuses that factor, as the reference reuses its MUMPS
    factorization for the forward and the adjoint."""

    def __init__(self, space, dofmaps, free_mask=None, dtype=None,
                 shift=1e-5):
        self.band = BandCholPrecond(space, dofmaps, dtype=dtype, shift=shift,
                                    free=free_mask)
        self.space = space

    def prepare(self, params, grad_keys=frozenset()):
        return ()

    def shard_state(self, spec):
        """Assemble the band from this rank's cells of the cell block and
        sum it over the ranks (BandCholPrecond.shard); the factor and its
        solves are replicated."""
        self.band.shard(spec.cells_of(self.space))

    def setup_state(self, u, params, ops_Ae, aux):
        return self.band.setup(ops_Ae)

    def apply_state(self, state, v):
        return self.band.apply(state, v)


def band_precond_factory(space, form, facet_forms=(), free_mask=None,
                         dtype=None, shift=1e-5):
    """A BandPrecond for a cell form and its facet forms, in the op layout
    of ImplicitPDE._assemble_ops: the cell block first, then one block per
    facet form. dtype / shift: see BandCholPrecond."""
    dofmaps = [form.space.dofmap] + [ff.block.dofmap for ff in facet_forms]
    return BandPrecond(space, dofmaps, free_mask=free_mask, dtype=dtype,
                       shift=shift)
