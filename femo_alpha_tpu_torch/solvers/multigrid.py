"""Geometric multigrid preconditioner on structured mesh hierarchies.

Port of femo_alpha_tpu/solvers/multigrid.py (V-cycle, node-block-Jacobi
Chebyshev smoothing, lane-major level operators, Jacobi-scaled dense
coarse inverse):

- transfers are separable factor-2 stencils on the combined dof grid;
  restriction is written as the explicit adjoint stencil of prolongation
  (strided slices + shifted adds), not derived by autograd
- the smoother is Chebyshev over a block-Jacobi split, targeting
  [lmin_ratio*lmax, lmax] with lmax from a CG-Lanczos estimate
- the coarsest level is solved with a Jacobi-scaled dense inverse
- the setup's assemblies (block-Jacobi blocks, coarse matrix) sum in a
  fixed order, never with atomics, so one design always gives the same
  V-cycle bits

The W-cycle, the Schwarz smoother, the cell-major layout and the generic
(index-table) transfer are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from ..spaces.fixed_order import fixed_order_scatter, sum_plan


# --------------------------------------------------------------------------
# transfer operators
# --------------------------------------------------------------------------


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


class StructuredTransfer:
    """Slice-based transfer for P1/P2 spaces on nested StructuredQuadMesh
    pairs (factor-2 refinement)."""

    def __init__(self, space_c, space_f):
        mc, mf = space_c.mesh, space_f.mesh
        if not (getattr(mc, "structured", False)
                and getattr(mf, "structured", False)
                and space_c.family in ("P", "CG", "Lagrange", "Q")
                and space_c.degree in (1, 2)
                and mf.nx == 2 * mc.nx and mf.ny == 2 * mc.ny):
            raise NotImplementedError(
                "the generic (unstructured) MG transfer is not ported to "
                "femo_alpha_tpu_torch yet (ROADMAP.md)")
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


class MixedTransfer:
    """Per-subspace transfers for a MixedSpace pair."""

    def __init__(self, W_c, W_f):
        self.subs = [StructuredTransfer(sc, sf)
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
    (n_scalar, bs, bs) arrays."""
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
    return A * free[:, None] * free[None, :] + torch.diag(1.0 - free)


# --------------------------------------------------------------------------
# the preconditioner
# --------------------------------------------------------------------------


class GeometricMG:
    """V-cycle preconditioner over a list of levels (fine -> coarse).

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
    """

    def __init__(self, levels, make_matvec, degree=2, lmin_ratio=0.25,
                 power_iters=25, max_coarse_dofs=30_000):
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
        self.transfers = [MixedTransfer(levels[k + 1]["space"],
                                        levels[k]["space"])
                          for k in range(len(levels) - 1)]

    # ----------------------------------------------------------- setup
    def setup(self, params, Ae0=None, bases=None):
        """Returns the state dict: per-level Ae, constrained operators
        (made once here, applied by every cycle), smoother blocks and lmax,
        and the coarse (scaled) dense inverse.

        Ae0: the fine level's element matrices when the caller already has
        them (level 0's make_Ae is then not called). bases: per-level
        affine bases, injected as p["_affine_basis"] for each make_Ae."""
        state = {"Ae": [], "matvec": [], "blocks": [], "lmax": []}
        p = params
        for k, lev in enumerate(self.levels):
            pk = p if bases is None else {**p, "_affine_basis": bases[k]}
            Ae = Ae0 if (k == 0 and Ae0 is not None) else lev["make_Ae"](pk)
            state["Ae"].append(Ae)
            free_k = lev["free"]
            W = lev["space"]
            if k < len(self.levels) - 1:
                Dinvs = block_jacobi_arrays(Ae.permute(2, 0, 1), W, free_k)
                sm = [D.permute(1, 2, 0).contiguous() for D in Dinvs]
                state["blocks"].append(sm)
                mv = self.make_matvec(Ae, W, free_k)
                state["matvec"].append(mv)
                state["lmax"].append(estimate_lmax(
                    mv, lambda v, W=W, sm=sm: apply_block_jacobi_T(W, sm, v),
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

    # ----------------------------------------------------------- apply
    def apply(self, state, b):
        """One V-cycle from a zero initial guess: the M^{-1} of PCG."""
        return self._cycle(state, 0, b)

    def _cycle(self, state, k, b):
        lev = self.levels[k]
        free = lev["free"]
        if k == len(self.levels) - 1:
            s = state["coarse_scale"]
            return s * (state["coarse_inv"] @ (s * b))
        W = lev["space"]
        mv = state["matvec"][k]
        sm = state["blocks"][k]
        lmax = state["lmax"][k]

        def Minv(v):
            return apply_block_jacobi_T(W, sm, v)

        x = chebyshev_smooth(mv, Minv, lmax, b, torch.zeros_like(b),
                             degree=self.degree, lmin_ratio=self.lmin_ratio)
        t = self.transfers[k]
        free_c = self.levels[k + 1]["free"]
        r_c = t.restrict(b - mv(x)) * free_c
        e_c = self._cycle(state, k + 1, r_c)
        x = x + free * t.prolong(e_c)
        return chebyshev_smooth(mv, Minv, lmax, b, x, degree=self.degree,
                                lmin_ratio=self.lmin_ratio)
