"""Krylov solvers on device tensors: preconditioned CG and restarted GMRES.

Port of femo_alpha_tpu/solvers/krylov.py::cg_solve and ::gmres_solve. The
vectors stay on the device in their own dtype (native f64 on the H100);
the stopping tests read a norm on the host, CG once per iteration, GMRES
once per Arnoldi step (its breakdown test) and once per restart cycle.
"""

from __future__ import annotations

import torch


def _identity(x):
    return x


def cg_solve(matvec, b, x0=None, M=None, tol=1e-10, atol=0.0, maxiter=1000,
             restarts=1):
    """Preconditioned conjugate gradient from x0 (zero when None).

    Stops when |r| <= max(tol * |b|, atol). Returns (x, info) with
    info = dict(iters, passes, resnorm, converged): `passes` lists the
    iterations of each pass (the first, then each restart that ran).
    matvec and M are functions v -> Av / M^{-1}v.

    restarts: after the recurrence-residual test fires, recompute the TRUE
    residual b - A x and re-enter the loop if it still exceeds the target
    (up to `restarts` times). The reported resnorm is a true residual."""
    M = M or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    target = max(tol * float(torch.linalg.norm(b)), atol)
    k = 0
    passes = []
    for _ in range(1 + max(0, restarts)):
        k0 = k
        r = b - matvec(x)
        z = M(r)
        rz = torch.dot(r, z)
        p = z
        while float(torch.linalg.norm(r)) > target and k < maxiter:
            Ap = matvec(p)
            alpha = rz / torch.dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = M(r)
            rz_new = torch.dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
            k += 1
        if k > k0 or not passes:
            passes.append(k - k0)
    resnorm = float(torch.linalg.norm(b - matvec(x)))
    info = {"iters": k, "passes": passes, "resnorm": resnorm,
            "converged": resnorm <= max(target, 1e-300)}
    return x, info


def _safe_normalize(x, thresh):
    """(x / |x|, |x|), or (0, 0) when |x| <= thresh (a device scalar)."""
    norm = torch.linalg.norm(x)
    use = norm > thresh
    return (torch.where(use, x / norm, torch.zeros_like(x)),
            torch.where(use, norm, torch.zeros_like(norm)))


def _gmres_cycle(A, M, b, x0, unit_r, r_norm, restart):
    """One restart cycle of left-preconditioned GMRES, as
    jax.scipy.sparse.linalg.gmres's `batched` method computes it: the full
    `restart`-step Arnoldi process on M(A(.)) with one classical
    Gram-Schmidt pass (the JAX code's "twice is enough" loop stops after
    one pass), stopped early only by a breakdown, then the least-squares
    problem by its normal equations, solved by Cholesky (H stays the
    identity in the rows no step reached). Returns (x, unit preconditioned
    residual, its norm, Arnoldi steps)."""
    eps = torch.finfo(b.dtype).eps
    V = b.new_zeros((restart + 1, b.shape[0]))
    V[0] = unit_r
    H = torch.eye(restart, restart + 1, dtype=b.dtype, device=b.device)
    steps = 0
    for k in range(restart):
        steps += 1
        v = M(A(V[k]))
        v_norm_0 = torch.linalg.norm(v)
        h = V @ v
        v = v - h @ V
        unit_v, v_norm_1 = _safe_normalize(v, eps * v_norm_0)
        V[k + 1] = unit_v
        h[k + 1] = v_norm_1
        H[k] = h
        if float(v_norm_1) == 0.0:
            break
    beta = b.new_zeros(restart + 1)
    beta[0] = r_norm
    y = torch.cholesky_solve((H @ beta)[:, None],
                             torch.linalg.cholesky(H @ H.T))[:, 0]
    x = x0 + y @ V[:-1]
    unit_r, r_norm = _safe_normalize(M(b - A(x)), eps * torch.ones_like(
        r_norm))
    return x, unit_r, r_norm, steps


def gmres_solve(matvec, b, x0=None, M=None, tol=1e-10, atol=0.0,
                restart=50, maxiter=20):
    """Restarted left-preconditioned GMRES from x0 (zero when None).

    Port of the JAX package's gmres_solve, which calls
    jax.scipy.sparse.linalg.gmres(solve_method="batched"): cycles of
    `restart` Arnoldi steps (restart is capped at the system size) while
    fewer than `maxiter` cycles ran and the PRECONDITIONED residual norm
    |M(b - A x)| exceeds max(tol * |b|, atol). (JAX also forms
    ptol = |M b| * min(1, atol / |b|) from Mb = M(b); its batched method
    does not read it.) Returns (x, info): info = dict(iters (Arnoldi
    steps), cycles, resnorm (the true residual |b - A x|), converged
    (resnorm <= 10 x the target, the JAX package's slack))."""
    M = M or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    restart = min(restart, b.shape[0])
    bnorm = float(torch.linalg.norm(b))
    target = max(tol * bnorm, atol)
    eps = torch.tensor(torch.finfo(b.dtype).eps, dtype=b.dtype,
                       device=b.device)
    unit_r, r_norm = _safe_normalize(M(b - matvec(x)), eps)
    cycles = steps = 0
    while cycles < maxiter and float(r_norm) > target:
        x, unit_r, r_norm, k = _gmres_cycle(matvec, M, b, x, unit_r, r_norm,
                                            restart)
        cycles += 1
        steps += k
    resnorm = float(torch.linalg.norm(b - matvec(x)))
    info = {"iters": steps, "cycles": cycles, "resnorm": resnorm,
            "converged": resnorm <= target * 10}
    return x, info
