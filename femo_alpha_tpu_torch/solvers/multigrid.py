"""Geometric multigrid preconditioner on structured mesh hierarchies.

Port of femo_alpha_tpu/solvers/multigrid.py (V- and W-cycles,
node-block-Jacobi or additive-Schwarz Chebyshev smoothing, lane-major
level operators, Jacobi-scaled dense coarse inverse):

- transfers on nested StructuredQuadMesh pairs are separable factor-2
  stencils on the combined dof grid, restriction written as the explicit
  adjoint stencil of prolongation (strided slices + shifted adds), not
  derived by autograd; any other nested pair takes the generic
  index-table `Transfer` (coarse basis weights at the fine dofs), whose
  restriction sums in a fixed order
- the smoother is Chebyshev over a block-Jacobi or a weighted
  additive-Schwarz split, targeting [lmin_ratio*lmax, lmax] with lmax from
  a CG-Lanczos estimate; the Schwarz apply's per-cell contraction is K1
  (cuda_kernels.cell_matvec_T) on the card
- the coarsest level is solved with a Jacobi-scaled dense inverse
- the setup's assemblies (smoother blocks, assembled diagonals, overlap
  counts, coarse matrix) sum in a fixed order, never with atomics, so one
  design always gives the same cycle bits

The cell-major layout is not ported (ROADMAP.md): every level is
lane-major.
"""

from __future__ import annotations

import numpy as np
import torch

from ..assembly.cuda_kernels import cell_matvec_T, gather_sum
from ..spaces.fixed_order import fixed_order_scatter, sum_plan


# --------------------------------------------------------------------------
# transfer operators
# --------------------------------------------------------------------------


class Transfer:
    """Prolongation/restriction between one (sub)space pair on nested
    meshes from index tables: dofs (nf, ndc), the coarse scalar dofs of
    each fine scalar dof, and weights (nf, ndc), the coarse basis at the
    fine dof's coordinate. Vector spaces share the scalar tables; the
    components ride the last axis. Tables go to each vector's device once;
    restriction, the exact transpose of prolongation, sums each coarse dof's
    entries in a fixed order (spaces/fixed_order.py)."""

    def __init__(self, dofs, weights, n_scalar_coarse, value_size):
        self.dofs = np.asarray(dofs, dtype=np.int64)
        self.weights = np.asarray(weights, dtype=np.float64)
        self.n_scalar_coarse = int(n_scalar_coarse)
        self.vs = int(value_size)
        self._index_cache = {}

    def _tables(self, device):
        key = ("tables", str(device))
        t = self._index_cache.get(key)
        if t is None:
            t = self._index_cache[key] = (
                torch.as_tensor(self.dofs.reshape(-1), device=device),
                torch.as_tensor(self.weights, device=device))
        return t

    def prolong(self, xc):
        dofs, w = self._tables(xc.device)
        g = xc.reshape(self.n_scalar_coarse, self.vs)[dofs].reshape(
            self.dofs.shape + (self.vs,))  # (nf, ndc, vs)
        return torch.sum(w.to(xc.dtype)[:, :, None] * g, dim=1).reshape(-1)

    def restrict(self, rf):
        nf, ndc = self.dofs.shape
        _, w = self._tables(rf.device)
        contrib = (w.to(rf.dtype)[:, :, None]
                   * rf.reshape(nf, self.vs)[:, None, :]).reshape(
                       nf * ndc, self.vs)
        plan = sum_plan(self, "restrict", self.dofs, rf.device)
        return fixed_order_scatter(contrib, plan,
                                   self.n_scalar_coarse).reshape(-1)


def _sl(G, axis, start, stop=None, stride=1):
    idx = [slice(None)] * G.dim()
    idx[axis] = slice(start, stop, stride)
    return G[tuple(idx)]


def _ileave(a, b, axis):
    """Interleave a (n+1 along axis) with b (n): [a0,b0,a1,b1,...,an]."""
    n = b.shape[axis]
    pairs = torch.stack([_sl(a, axis, 0, n), b], dim=axis + 1)
    shape = a.shape[:axis] + (2 * n,) + a.shape[axis + 1:]
    return torch.cat([pairs.reshape(shape), _sl(a, axis, n, n + 1)],
                     dim=axis)


def _pad1(a, axis, before, after):
    shape = list(a.shape)
    parts = []
    if before:
        shape[axis] = before
        parts.append(a.new_zeros(shape))
    parts.append(a)
    if after:
        shape[axis] = after
        parts.append(a.new_zeros(shape))
    return torch.cat(parts, dim=axis)


def _restrict_axis(G, axis, degree):
    """Exact adjoint of `_prolong_axis` along `axis`.

    degree 1: fine grid 2n+1 -> coarse n+1
      a[i] = g[2i] + 0.5 g[2i-1] + 0.5 g[2i+1]           (boundary-clipped)
    degree 2: fine combined grid 4n+1 -> coarse combined 2n+1
      V[i] = g[4i] + 0.375 g[4i+1] - 0.125 g[4i-3]
                   - 0.125 g[4i+3] + 0.375 g[4i-1]       (boundary-clipped)
      M[i] = g[4i+2] + 0.75 (g[4i+1] + g[4i+3])
    """
    if degree == 1:
        even = _sl(G, axis, 0, None, 2)
        half = 0.5 * _sl(G, axis, 1, None, 2)
        return even + _pad1(half, axis, 0, 1) + _pad1(half, axis, 1, 0)
    g0 = _sl(G, axis, 0, None, 4)
    g1 = _sl(G, axis, 1, None, 4)
    g2 = _sl(G, axis, 2, None, 4)
    g3 = _sl(G, axis, 3, None, 4)
    V = (g0 + _pad1(0.375 * g1 - 0.125 * g3, axis, 0, 1)
         + _pad1(-0.125 * g1 + 0.375 * g3, axis, 1, 0))
    M = g2 + 0.75 * (g1 + g3)
    return _ileave(V, M, axis)


def _prolong_axis(G, axis, degree):
    """1D factor-2 prolongation along `axis` of a combined dof grid.

    degree 1: grid size n+1 -> 2n+1 (vertex copy + midpoint average).
    degree 2: combined vertex/midpoint grid 2n+1 -> 4n+1; fine nodes at
    coarse-local xi = 1/4, 3/4 use the 1D quadratic basis values
    N(1/4) = (0.375, 0.75, -0.125), N(3/4) reversed."""
    if degree == 1:
        mid = 0.5 * (_sl(G, axis, 0, -1) + _sl(G, axis, 1, None))
        return _ileave(G, mid, axis)
    V = _sl(G, axis, 0, None, 2)
    M = _sl(G, axis, 1, None, 2)
    Vl, Vr = _sl(V, axis, 0, -1), _sl(V, axis, 1, None)
    o1 = 0.375 * Vl + 0.75 * M - 0.125 * Vr
    o3 = -0.125 * Vl + 0.75 * M + 0.375 * Vr
    n = M.shape[axis]
    quads = torch.stack([Vl, o1, M, o3], dim=axis + 1)
    shape = G.shape[:axis] + (4 * n,) + G.shape[axis + 1:]
    return torch.cat([quads.reshape(shape), _sl(V, axis, n, n + 1)],
                     dim=axis)


def _structured_pair(space_c, space_f):
    """Whether StructuredTransfer applies: P1/P2 spaces on nested
    StructuredQuadMesh pairs refined by a factor of 2."""
    mc, mf = space_c.mesh, space_f.mesh
    return bool(getattr(mc, "structured", False)
                and getattr(mf, "structured", False)
                and space_c.family in ("P", "CG", "Lagrange", "Q")
                and space_c.degree in (1, 2)
                and mf.nx == 2 * mc.nx and mf.ny == 2 * mc.ny)


class StructuredTransfer:
    """Slice-based transfer for P1/P2 spaces on nested StructuredQuadMesh
    pairs (factor-2 refinement)."""

    def __init__(self, space_c, space_f):
        mc, mf = space_c.mesh, space_f.mesh
        if not _structured_pair(space_c, space_f):
            raise ValueError("StructuredTransfer needs P1/P2 spaces on "
                             "nested structured meshes (factor 2)")
        self.vs = space_c.value_size
        self.degree = space_c.degree
        self.nxc, self.nyc = mc.nx, mc.ny
        self.nxf, self.nyf = mf.nx, mf.ny
        self.n_c = space_c.n_dofs
        self.n_f = space_f.n_dofs

    def _pack(self, x, nx, ny):
        vs = self.vs
        if self.degree == 1:
            return x.reshape(nx + 1, ny + 1, vs)
        nV = (nx + 1) * (ny + 1) * vs
        nEX = nx * (ny + 1) * vs
        nEY = (nx + 1) * ny * vs
        V = x[:nV].reshape(nx + 1, ny + 1, vs)
        EX = x[nV:nV + nEX].reshape(nx, ny + 1, vs)
        EY = x[nV + nEX:nV + nEX + nEY].reshape(nx + 1, ny, vs)
        C = x[nV + nEX + nEY:].reshape(nx, ny, vs)
        rows_even = _ileave(V, EY, axis=1)    # (nx+1, 2ny+1, vs)
        rows_odd = _ileave(EX, C, axis=1)     # (nx,   2ny+1, vs)
        return _ileave(rows_even, rows_odd, axis=0)

    def _unpack(self, G):
        if self.degree == 1:
            return G.reshape(-1)
        return torch.cat([G[0::2, 0::2].reshape(-1), G[1::2, 0::2].reshape(-1),
                          G[0::2, 1::2].reshape(-1),
                          G[1::2, 1::2].reshape(-1)])

    def prolong(self, xc):
        G = self._pack(xc, self.nxc, self.nyc)
        G = _prolong_axis(G, 0, self.degree)
        G = _prolong_axis(G, 1, self.degree)
        return self._unpack(G)

    def restrict(self, rf):
        G = self._pack(rf, self.nxf, self.nyf)
        G = _restrict_axis(G, 1, self.degree)
        G = _restrict_axis(G, 0, self.degree)
        return self._unpack(G)


def make_space_transfer(space_c, space_f):
    """The slice-based transfer where it applies, the generic index-table
    one otherwise."""
    if _structured_pair(space_c, space_f):
        return StructuredTransfer(space_c, space_f)
    return space_transfer(space_c, space_f)


def _structured_locate(mesh_c, pts):
    """Containing coarse cell and local reference coordinates of points on
    a StructuredQuadMesh (host numpy)."""
    xy = np.asarray(pts)[:, :2]
    c = np.asarray(mesh_c.coords)[:, :2]
    x0, y0 = c[:, 0].min(), c[:, 1].min()
    hx = (c[:, 0].max() - x0) / mesh_c.nx
    hy = (c[:, 1].max() - y0) / mesh_c.ny
    fi = (xy[:, 0] - x0) / hx
    fj = (xy[:, 1] - y0) / hy
    i = np.clip(np.floor(fi).astype(np.int64), 0, mesh_c.nx - 1)
    j = np.clip(np.floor(fj).astype(np.int64), 0, mesh_c.ny - 1)
    xi = np.stack([fi - i, fj - j], axis=1)
    cells = (i * mesh_c.ny + j).astype(np.int32)
    return cells, xi


def space_transfer(space_c, space_f):
    """The generic Transfer for one FunctionSpace pair on nested structured
    quad meshes (the coarse space nested in the fine one: same family, mesh
    refined by integer factors), so that prolongation is exact
    interpolation and restriction its transpose."""
    cells, xi = _structured_locate(space_c.mesh, space_f.dof_coords)
    w = space_c.element.tabulate(xi, 0)  # (nf, ndc)
    dofs = space_c.scalar_dofmap[cells]  # (nf, ndc)
    return Transfer(dofs, w, space_c.n_scalar_dofs, space_f.value_size)


class MixedTransfer:
    """Per-subspace transfers for a MixedSpace pair."""

    def __init__(self, W_c, W_f):
        self.subs = [make_space_transfer(sc, sf)
                     for sc, sf in zip(W_c.subspaces, W_f.subspaces)]
        self.W_c, self.W_f = W_c, W_f

    def prolong(self, xc):
        return torch.cat([t.prolong(x) for t, x in
                          zip(self.subs, self.W_c.split(xc))])

    def restrict(self, rf):
        return torch.cat([t.restrict(r) for t, r in
                          zip(self.subs, self.W_f.split(rf))])


# --------------------------------------------------------------------------
# smoother building blocks
# --------------------------------------------------------------------------


def _batch_inv(D):
    """Batched small-matrix inverse: closed-form adjugate for bs <= 3, LU
    for larger blocks."""
    bs = D.shape[-1]
    if bs == 1:
        return 1.0 / D
    if bs == 2:
        a, b = D[..., 0, 0], D[..., 0, 1]
        c, d = D[..., 1, 0], D[..., 1, 1]
        det = a * d - b * c
        adj = torch.stack([torch.stack([d, -b], -1),
                           torch.stack([-c, a], -1)], -2)
        return adj / det[..., None, None]
    if bs == 3:
        a = D
        c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
        c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
        c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
        c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
        c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
        c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
        c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
        c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
        c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
        det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
        adj = torch.stack([torch.stack([c00, c10, c20], -1),
                           torch.stack([c01, c11, c21], -1),
                           torch.stack([c02, c12, c22], -1)], -2)
        return adj / det[..., None, None]
    return torch.linalg.inv(D)


def block_jacobi_arrays(Ae, W, free):
    """Per-node value_size x value_size inverted diagonal blocks for each
    subspace of a MixedSpace, from cell-major element matrices
    (nc, nd, nd), assembled in a fixed order. Returns a list of
    (n_scalar, bs, bs) arrays. W a spaces.CellRange: Ae holds its cells,
    and the blocks are summed over the ranks before they are inverted."""
    nc = Ae.shape[0]
    out = []
    for i, sub in enumerate(W.subspaces):
        o = W.local_slices[i].start
        bs = sub.value_size
        nds = sub.element.ndof
        subA = Ae[:, o: o + nds * bs, o: o + nds * bs].reshape(
            nc, nds, bs, nds, bs)
        # node-diagonal blocks: (nc, bs, bs, nds) -> (nc, nds, bs, bs)
        blocks = torch.diagonal(subA, dim1=1, dim2=3).permute(0, 3, 1, 2)
        plan = sum_plan(sub, "node_blocks", sub.scalar_dofmap, Ae.device)
        D = fixed_order_scatter(
            blocks.reshape(nc * nds, bs * bs), plan, sub.n_scalar_dofs
        ).reshape(sub.n_scalar_dofs, bs, bs)
        if getattr(W, "comm", None) is not None:
            W.comm.all_reduce(D)  # one rank's cells: sum over the ranks
        o_g = int(W.offsets[i])
        fm = free[o_g: o_g + sub.n_dofs].reshape(sub.n_scalar_dofs, bs)
        eye = torch.eye(bs, dtype=D.dtype, device=D.device)[None]
        D = D * fm[:, :, None] * fm[:, None, :] + eye * (1.0 - fm)[:, :, None]
        dd = torch.abs(torch.diagonal(D, dim1=1, dim2=2)).sum(dim=1)
        D = torch.where((dd == 0.0)[:, None, None], eye, D)
        out.append(_batch_inv(D))
    return out


def apply_block_jacobi_T(W, Dinv_Ts, v):
    """Lane-major block-Jacobi apply: Dinv_Ts[i] is (bs, bs, n_scalar)."""
    parts = []
    for i, sub in enumerate(W.subspaces):
        o_g = int(W.offsets[i])
        bs = sub.value_size
        segT = v[o_g: o_g + sub.n_dofs].reshape(-1, bs).T  # (bs, ns)
        yT = torch.sum(Dinv_Ts[i] * segT[None, :, :], dim=1)  # (bs, ns)
        parts.append(yT.T.reshape(-1))
    return torch.cat(parts)


def schwarz_arrays(Ae, W, free):
    """Weighted additive-Schwarz smoother over diagonal-corrected element
    blocks, from cell-major element matrices (nc, nd, nd): each cell's
    block is its element matrix with the diagonal replaced by the ASSEMBLED
    diagonal (a bare element matrix is singular: rigid-body modes), BC
    rows/cols eliminated, inverted in batch. The apply is
    M v = sum_e R_e^T sqrt(w) Ahat_e^{-1} sqrt(w) R_e v with w = 1/overlap
    count, symmetric PSD by construction. The assembled diagonal and the
    overlap counts sum in a fixed order (the space's scatter_add).
    Returns (inv (nc, nd, nd), sqrt_w_cell (nc, nd))."""
    nc, nd, _ = Ae.shape
    dtype, dev = Ae.dtype, Ae.device
    fm = W.gather(free.to(dtype))  # (nc, nd)
    diag_g = W.scatter_add(torch.diagonal(Ae, dim1=1, dim2=2))
    eye = torch.eye(nd, dtype=dtype, device=dev)
    dcell = W.gather(diag_g)  # assembled diagonal per cell dof
    Ahat = Ae * (1.0 - eye) + eye * dcell[:, :, None]
    Ahat = Ahat * fm[:, :, None] * fm[:, None, :] + eye * (
        1.0 - fm)[:, :, None]
    counts = W.scatter_add(torch.ones((nc, nd), dtype=dtype, device=dev))
    w = torch.where(counts > 0, 1.0 / counts, torch.ones_like(counts))
    sqrt_w_cell = torch.sqrt(W.gather(w))
    return torch.linalg.inv(Ahat), sqrt_w_cell


def schwarz_arrays_T(Ae_T, W, free):
    """schwarz_arrays from lane-major element matrices (nd, nd, nc), in the
    lane-major layout apply_schwarz_T takes: (inv_T (nd, nd, nc),
    sqrt_w_T (nd, nc)), contiguous and detached (K1's input contract)."""
    with torch.no_grad():
        inv, sw = schwarz_arrays(Ae_T.permute(2, 0, 1), W, free)
        return inv.permute(1, 2, 0).contiguous(), sw.T.contiguous()


def _schwarz_tables(W, device):
    """(dofmap_T (nd, nc), inv (n, w)) of W's lane tables as int64 on
    `device`, cached on the space: one gather of a vector's cell values and
    the fixed-order dof sums of gather_sum."""
    key = ("schwarz", str(device))
    t = W._index_cache.get(key)
    if t is None:
        t = W._index_cache[key] = tuple(
            a.long() for a in W.lane_tables(device))
    return t


def apply_schwarz_T(W, inv_T, sqrt_w_T, v):
    """Lane-major Schwarz apply: inv_T (nd, nd, nc), sqrt_w_T (nd, nc).
    One gather of the cell values (the space's lane tables), the per-cell
    contraction by K1 (cuda_kernels.cell_matvec_T: the kernel on a CUDA
    tensor, its plain twin on a CPU one), and each dof's sum over its cell
    entries in the tables' fixed order (cuda_kernels.gather_sum). W a
    spaces.CellRange: one rank's cells, then the ranks' all_reduce."""
    dofmap_T, inv = _schwarz_tables(W, v.device)
    vcT = v[dofmap_T] * sqrt_w_T
    y = gather_sum(cell_matvec_T(inv_T, vcT) * sqrt_w_T, inv)
    comm = getattr(W, "comm", None)
    return y if comm is None else comm.all_reduce(y)


def estimate_lmax(matvec, Minv, n, dtype, device, iters=25):
    """lambda_max(M^{-1} A) estimate for an SPD (A, M) pair via the
    CG-Lanczos connection: `iters` preconditioned-CG steps on a fixed
    right-hand side, the Lanczos tridiagonal from the CG alpha/beta
    coefficients, and its largest Ritz value. Fixed trip count and
    breakdown-guarded (a converged CG keeps the last valid coefficients)
    without reading any value on the host. The remaining underestimate is
    covered by the Chebyshev safety margin (chebyshev_smooth)."""
    b = torch.sin(torch.arange(1, n + 1, dtype=dtype, device=device) * 0.7
                  ) + 0.01
    x = torch.zeros_like(b)
    r = b
    z = Minv(r)
    p = z
    rz = torch.dot(r, z)
    one = torch.ones((), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    alphas, betas, live = [], [], []
    for _ in range(iters):
        Ap = matvec(p)
        pAp = torch.dot(p, Ap)
        ok = (pAp > 0) & (rz > 0)
        alpha = torch.where(ok, rz / torch.where(pAp != 0, pAp, one), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = Minv(r)
        rz_new = torch.dot(r, z)
        beta = torch.where(ok, rz_new / torch.where(rz != 0, rz, one), zero)
        p = z + beta * p
        alphas.append(torch.where(ok, alpha, one))
        betas.append(beta)
        live.append(ok.to(dtype))
        rz = torch.where(ok, rz_new, rz)
    alphas, betas, live = (torch.stack(alphas), torch.stack(betas),
                           torch.stack(live))
    # Lanczos tridiagonal from CG coefficients:
    #   T[k,k]   = 1/alpha_k + beta_{k-1}/alpha_{k-1}
    #   T[k,k+1] = sqrt(beta_k)/alpha_k
    inv_a = live / torch.where(alphas != 0, alphas, one)
    prev = torch.cat([zero[None], betas[:-1] * inv_a[:-1]])
    diag = inv_a + prev
    off = torch.sqrt(torch.clamp(betas, min=0.0)) * inv_a * live
    T = (torch.diag(diag) + torch.diag(off[:-1], 1)
         + torch.diag(off[:-1], -1))
    lmax = torch.max(torch.linalg.eigvalsh(T))
    # degenerate guard (all-dead iterations): 2.0
    return torch.where(lmax > 0, lmax, 2.0 * one)


def chebyshev_smooth(matvec, Minv, lmax, b, x, degree=2, lmin_ratio=0.25):
    """Preconditioned Chebyshev iteration targeting [lmin_ratio*lmax, lmax]
    with a 1.10 safety margin over the lambda_max estimate (Ritz estimates
    approach lambda_max from below, and a high-degree Chebyshev polynomial
    amplifies modes above its interval explosively)."""
    lmax = lmax * 1.10
    lmin = lmax * lmin_ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    z = Minv(b - matvec(x))
    d = z / theta
    x = x + d
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        z = Minv(b - matvec(x))
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * z
        x = x + d
        rho = rho_new
    return x


def dense_constrained(Ae, W, free):
    """Dense assembly, in a fixed order, of cell-major element matrices
    (nc, nd, nd) on the space W with BC rows/cols eliminated (identity on
    constrained dofs): the coarsest-level operator."""
    n = int(W.n_dofs)
    dm = np.asarray(W.dofmap, dtype=np.int64)
    plan = sum_plan(W, "dense", dm[:, :, None] * n + dm[:, None, :],
                     Ae.device)
    A = fixed_order_scatter(Ae.reshape(-1), plan, n * n).reshape(n, n)
    if getattr(W, "comm", None) is not None:
        W.comm.all_reduce(A)  # one rank's cells: sum over the ranks
    return A * free[:, None] * free[None, :] + torch.diag(1.0 - free)


# --------------------------------------------------------------------------
# the preconditioner
# --------------------------------------------------------------------------


def _free_in(lev, dtype):
    """A level's free-dof mask in `dtype`, cast once and kept on the
    level (the mask itself when it has that dtype)."""
    free = lev["free"]
    if free.dtype == dtype:
        return free
    cast = lev.setdefault("_free_as", {})
    if dtype not in cast:
        cast[dtype] = free.to(dtype)
    return cast[dtype]


class GeometricMG:
    """V- or W-cycle preconditioner over a list of levels (fine -> coarse).

    Static structure (spaces, transfers, free masks, matvec factory) lives
    on the object; per-design data (element matrices, block inverses,
    smoother spectra, coarse inverse) is the state dict made by `setup`.

    levels: list of dicts with keys
      space    — MixedSpace of the level
      free     — (n_dofs,) 1.0/0.0 free-dof mask tensor
      make_Ae  — callable(params) -> lane-major element matrices (nd,nd,nc)
      coarsen  — callable(params) -> params of the next level (absent on
                 the coarsest level)
    make_matvec(Ae, space, free) -> constrained lane-major operator.

    cycle: "V", or "W" (two recursive corrections per level,
    B2 = 2B - BAB, symmetric when B is: it holds the two-grid rate where
    V-cycle rates degrade with the level count, at about twice the coarse
    levels' smoothing cost). smoother: "block_jacobi" (per-node vs x vs
    blocks) or "schwarz" (weighted additive Schwarz over
    diagonal-corrected element blocks: stronger on shells, one inverted
    element matrix per cell of extra memory). degree: the Chebyshev degree,
    an int or a per-level sequence (fine -> coarse; a shorter sequence
    repeats its last entry).
    """

    def __init__(self, levels, make_matvec, degree=2, lmin_ratio=0.25,
                 power_iters=25, max_coarse_dofs=30_000, cycle="V",
                 smoother="block_jacobi"):
        if cycle not in ("V", "W"):
            raise ValueError(f"GeometricMG: cycle {cycle!r} (V or W)")
        if smoother not in ("block_jacobi", "schwarz"):
            raise ValueError(f"GeometricMG: smoother {smoother!r} "
                             "(block_jacobi or schwarz)")
        n_coarse = int(levels[-1]["space"].n_dofs)
        if n_coarse > max_coarse_dofs:
            raise ValueError(
                f"coarsest level has {n_coarse} dofs — the dense coarse "
                f"solve would be O(n^3); add more levels or raise "
                f"coarsest-cells so the hierarchy bottoms out below "
                f"{max_coarse_dofs} dofs")
        self.levels = levels
        self.make_matvec = make_matvec
        self.degree = degree
        self.lmin_ratio = lmin_ratio
        self.power_iters = power_iters
        self.cycle = cycle
        self.smoother = smoother
        self.transfers = [MixedTransfer(levels[k + 1]["space"],
                                        levels[k]["space"])
                          for k in range(len(levels) - 1)]
        self.spec = None

    def shard(self, spec):
        """Split every level over the ranks of a CellShardSpec
        (parallel/product.py): `setup` then builds this rank's cells of
        each level's Ae (its assembler `asm`, or the caller's Ae0 on the
        fine level), smoother blocks and operator, and sums the global
        pieces (smoother blocks, the coarse matrix) over the ranks; the
        transfers, smoother inverses and coarse inverse are replicated. A
        level with a bare `make_Ae` and no `asm` does not split its
        assembly: its Ae is built whole on every rank and cut to the
        rank's cells."""
        for lev in self.levels:
            view = spec.cells_of(lev["space"])
            if lev.get("asm") is not None:
                lev["asm"].shard(view)
            lev["cells"] = view
        self.spec = spec

    # ----------------------------------------------------------- setup
    def setup(self, params, Ae0=None, dtype=None, bases=None):
        """Returns the state dict: per-level Ae, constrained operators
        (made once here, applied by every cycle), free masks, smoother
        blocks and lmax, and the coarse (scaled) dense inverse.

        Ae0: the fine level's element matrices when the caller already has
        them (level 0's make_Ae is then not called). dtype: cast the
        floating parameters and Ae0 to it first, so that the whole state is
        built in that precision (f32: the levels' forms and bases are f32
        too, models/rm_shell/mg.py) — lmax in it, the coarse inverse in
        it, every smoother and residual pass on the f32 kernel builds.
        bases: per-level affine bases, injected as p["_affine_basis"] for
        each make_Ae."""
        if dtype is not None:
            params = {k: (v.to(dtype) if torch.is_tensor(v)
                          and v.is_floating_point() else v)
                      for k, v in params.items()}
            Ae0 = None if Ae0 is None else Ae0.to(dtype).contiguous()
        if self.spec is not None:
            from ..parallel.product import _cell_axis_cut
        state = {"Ae": [], "matvec": [], "free": [], "blocks": [],
                 "lmax": [], "space": []}
        p = params
        for k, lev in enumerate(self.levels):
            pk = p if bases is None else {**p, "_affine_basis": bases[k]}
            Ae = Ae0 if (k == 0 and Ae0 is not None) else lev["make_Ae"](pk)
            # the level's space, or this rank's cells of it under a split
            W = lev["cells"] if self.spec is not None else lev["space"]
            if self.spec is not None:
                # built on the range already, or whole (a bare make_Ae)
                Ae = _cell_axis_cut(Ae, W)
            state["Ae"].append(Ae)
            free_k = _free_in(lev, Ae.dtype)
            state["free"].append(free_k)
            state["space"].append(W)
            if k < len(self.levels) - 1:
                sm = self._smoother_arrays(Ae, W, free_k)
                state["blocks"].append(sm)
                mv = self.make_matvec(Ae, W, free_k)
                state["matvec"].append(mv)
                state["lmax"].append(estimate_lmax(
                    mv, lambda v, W=W, sm=sm: self._smoother_apply(W, sm, v),
                    int(W.n_dofs), Ae.dtype, Ae.device,
                    iters=self.power_iters))
                p = lev["coarsen"](p)
            else:
                A = dense_constrained(Ae.permute(2, 0, 1), W, free_k)
                s = 1.0 / torch.sqrt(torch.abs(torch.diagonal(A)))
                state["coarse_inv"] = torch.linalg.inv(
                    A * s[:, None] * s[None, :])
                state["coarse_scale"] = s
        return state

    def _smoother_arrays(self, Ae, W, free):
        """Lane-major smoother state of a level from its lane-major Ae."""
        if self.smoother == "schwarz":
            return schwarz_arrays_T(Ae, W, free)
        Dinvs = block_jacobi_arrays(Ae.permute(2, 0, 1), W, free)
        return [D.permute(1, 2, 0).contiguous() for D in Dinvs]

    def _smoother_apply(self, W, sm, v):
        if self.smoother == "schwarz":
            return apply_schwarz_T(W, sm[0], sm[1], v)
        return apply_block_jacobi_T(W, sm, v)

    def _degree_at(self, k):
        """The Chebyshev degree of level k (`degree` an int, or a per-level
        sequence whose last entry repeats)."""
        if isinstance(self.degree, (list, tuple)):
            return self.degree[min(k, len(self.degree) - 1)]
        return self.degree

    # ----------------------------------------------------------- apply
    def apply(self, state, b):
        """One cycle from a zero initial guess: the M^{-1} of PCG."""
        return self._cycle(state, 0, b)

    def _cycle(self, state, k, b):
        free = state["free"][k]
        if k == len(self.levels) - 1:
            s = state["coarse_scale"]
            return s * (state["coarse_inv"] @ (s * b))
        W = state["space"][k]
        mv = state["matvec"][k]
        sm = state["blocks"][k]
        lmax = state["lmax"][k]

        def Minv(v):
            return self._smoother_apply(W, sm, v)

        deg = self._degree_at(k)
        x = chebyshev_smooth(mv, Minv, lmax, b, torch.zeros_like(b),
                             degree=deg, lmin_ratio=self.lmin_ratio)
        t = self.transfers[k]
        free_c = state["free"][k + 1]
        r_c = t.restrict(b - mv(x)) * free_c
        e_c = self._cycle(state, k + 1, r_c)
        if self.cycle == "W" and k + 1 < len(self.levels) - 1:
            mv_c = state["matvec"][k + 1]
            e_c = e_c + self._cycle(state, k + 1, r_c - mv_c(e_c))
        x = x + free * t.prolong(e_c)
        return chebyshev_smooth(mv, Minv, lmax, b, x, degree=deg,
                                lmin_ratio=self.lmin_ratio)
