"""Preconditioned conjugate gradient on device tensors.

Port of femo_alpha_tpu/solvers/krylov.py::cg_solve. The vectors stay on the
device in their own dtype (native f64 on the H100); the stopping test reads
the residual norm on the host once per iteration.
"""

from __future__ import annotations

import torch


def _identity(x):
    return x


def cg_solve(matvec, b, M=None, tol=1e-10, maxiter=1000, restarts=1):
    """Preconditioned conjugate gradient from a zero initial guess.

    Returns (x, info) with info = dict(iters, passes, resnorm, converged):
    `passes` lists the iterations of each pass (the first, then each
    restart that ran). matvec and M are functions v -> Av / M^{-1}v.

    restarts: after the recurrence-residual test fires, recompute the TRUE
    residual b - A x and re-enter the loop if it still exceeds the target
    (up to `restarts` times). The reported resnorm is a true residual."""
    M = M or _identity
    x = torch.zeros_like(b)
    target = tol * float(torch.linalg.norm(b))
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
