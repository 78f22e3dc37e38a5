"""Generalized symmetric eigensolvers: K phi = lam M phi, smallest modes
(port of femo_alpha_tpu/solvers/eigen.py).

- `lobpcg`: matrix-free block LOBPCG (Knyazev) over the solve path's
  operators, preconditioned by its preconditioner (the MG V-cycle, the band
  Cholesky or the dense solve). The port's fused operator and V-cycle take
  one vector, so a block apply is a loop over the block's columns, each
  one fused-operator call or one V-cycle (`block_apply`); the small
  (<= 3k x 3k) Rayleigh-Ritz algebra is torch.linalg.eigh on the same
  device, with the basis pruned on the host (dynamic shapes).
- `dense_generalized_eigh`: Cholesky reduction to a standard symmetric
  problem for small n.

Eigenvalue derivatives never form dK/dh or dM/dh: at a converged pair the
Rayleigh quotient phi^T K(p) phi / phi^T M(p) phi is stationary in phi, so
its autograd gradient at fixed phi is the exact eigenvalue gradient (see
RMShellModel.evaluate_modal).
"""

from __future__ import annotations

import torch


def block_apply(mv):
    """Lift a vector map (n,) -> (n,) to a block apply (n, k) -> (n, k),
    one call per column. `skip` (optional, k booleans) names columns that
    are zero: their result is zero without a call (every map here is
    linear)."""

    def apply(V, skip=None):
        cols = []
        for j in range(V.shape[1]):
            if skip is not None and skip[j]:
                cols.append(torch.zeros_like(V[:, j]))
            else:
                cols.append(mv(V[:, j].contiguous()))
        return torch.stack(cols, dim=1)

    return apply


def dense_generalized_eigh(Kd, Md, n_modes=None):
    """Smallest eigenpairs of the dense SPD pencil (Kd, Md) via Cholesky
    reduction: M = L L^T, eigh(L^-1 K L^-T), phi = L^-T v. Returns
    (lam (k,), Phi (n, k)) with Phi M-orthonormal."""
    L = torch.linalg.cholesky(Md)
    Z = torch.linalg.solve_triangular(L, Kd, upper=False)
    A = torch.linalg.solve_triangular(L, Z.T, upper=False)
    A = 0.5 * (A + A.T)
    w, V = torch.linalg.eigh(A)
    Phi = torch.linalg.solve_triangular(L.T, V, upper=True)
    if n_modes is not None:
        w, Phi = w[:n_modes], Phi[:, :n_modes]
    return w, Phi


def _ritz(S, AS, BS, k, drop_tol=1e-12):
    """Rayleigh-Ritz on span(S): returns (theta (k,), C (m, k)) with C
    G_B-orthonormal, dropping near-dependent basis directions."""
    GA = S.T @ AS
    GB = S.T @ BS
    GA = 0.5 * (GA + GA.T)
    GB = 0.5 * (GB + GB.T)
    w, U = torch.linalg.eigh(GB)
    w_host = w.cpu()
    keep = torch.nonzero(w_host > drop_tol * float(w_host[-1]))[:, 0]
    if keep.numel() < k:
        raise RuntimeError(
            f"LOBPCG basis collapsed: {keep.numel()} independent directions "
            f"for {k} requested modes")
    keep = keep.to(S.device)
    Y = U[:, keep] / torch.sqrt(w[keep])
    At = Y.T @ GA @ Y
    At = 0.5 * (At + At.T)
    theta, Z = torch.linalg.eigh(At)
    C = Y @ Z[:, :k]
    return theta[:k], C


def lobpcg(A, B, X0, T=None, tol=1e-8, maxiter=200, free_mask=None):
    """Locally optimal block preconditioned CG for the k smallest eigenpairs
    of A x = lam B x (A, B symmetric; B positive definite on the free
    subspace).

    A, B, T: callables (n,) -> (n,) (T approximates A^-1; defaults to the
    identity). X0: (n, k) start block. free_mask: constrained dofs are
    projected out of every block.

    Returns (lam (k,), X (n, k), resnorms (k,), iters); X is B-orthonormal.
    The loop runs on the host; each block apply is one call per column
    (columns that soft locking zeroed are skipped: they stay zero).

    The relative-residual floor of a small eigenvalue is ~eps*lam_max/lam_i
    (the roundoff of A@x carries the full operator scale), which can sit
    above a tight tol; the loop therefore keeps the best-so-far block and
    returns it once max(res) has not improved for `stall` iterations. Ritz
    values converge as res^2, so eigenvalues are far more accurate than
    res.
    """
    stall = 10
    X = torch.as_tensor(X0)
    n, k = X.shape
    proj = None
    if free_mask is not None:
        fm = free_mask.reshape(n, 1).to(X.dtype)

        def proj(V):
            return fm * V

        X = proj(X)
    bA, bB = block_apply(A), block_apply(B)
    bT = block_apply(T) if T is not None else (lambda V, skip=None: V)

    # B-orthonormalize the start block
    BX = bB(X)
    _, C = _ritz(X, bA(X), BX, k)
    P = AP = BP = None
    X = X @ C
    AX, BX = bA(X), bB(X)
    lam = torch.sum(X * AX, dim=0)
    res = torch.ones(k, dtype=X.dtype, device=X.device)
    best = None
    best_it = 0
    it = 0
    for it in range(1, maxiter + 1):
        R = AX - BX * lam[None, :]
        denom = (torch.linalg.norm(AX, dim=0)
                 + torch.abs(lam) * torch.linalg.norm(BX, dim=0))
        res = torch.linalg.norm(R, dim=0) / torch.clamp(denom, min=1e-300)
        res_max = float(torch.max(res))
        if best is None or res_max < float(torch.max(best[2])):
            best = (lam, X, res)
            best_it = it
        if res_max < tol:
            best = (lam, X, res)
            break
        if it - best_it >= stall:
            break
        # soft locking: converged columns contribute no new search
        # directions (their preconditioned residuals are roundoff noise,
        # which would degrade the converged modes); zeroed columns fall
        # below the Gram drop tolerance and leave the basis
        act_host = (res >= tol).cpu()
        skip = [not bool(a) for a in act_host]
        active = act_host.to(device=X.device, dtype=X.dtype)[None, :]
        W = bT(R, skip) * active
        if proj is not None:
            W = proj(W)
        # B-orthogonalize W against X: near convergence W turns nearly
        # parallel to X, flooring the Gram conditioning at ~sqrt(eps)
        W = W - X @ (BX.T @ W)
        # normalize W's columns for Gram conditioning
        wn = torch.clamp(torch.linalg.norm(W, dim=0), min=1e-300)
        W = W / wn[None, :] * active
        AW, BW = bA(W, skip), bB(W, skip)
        if P is None:
            S, AS, BS = (torch.hstack([X, W]), torch.hstack([AX, AW]),
                         torch.hstack([BX, BW]))
        else:
            S, AS, BS = (torch.hstack([X, W, P]), torch.hstack([AX, AW, AP]),
                         torch.hstack([BX, BW, BP]))
        lam, C = _ritz(S, AS, BS, k)
        # the new X from the Ritz combination; P = its W/P component (the
        # classical three-term recurrence), B-normalized
        Cp = C.clone()
        Cp[:k] = 0.0
        Xn, AXn, BXn = S @ C, AS @ C, BS @ C
        Pn, APn, BPn = S @ Cp, AS @ Cp, BS @ Cp
        pn = torch.sqrt(torch.clamp(torch.sum(Pn * BPn, dim=0), min=1e-300))
        P, AP, BP = (Pn / pn * active, APn / pn * active,
                     BPn / pn * active)
        X, AX, BX = Xn, AXn, BXn
    lam, X, res = best
    return lam, X, res, it
