"""Newton solver with convergence control (port of
femo_alpha_tpu/solvers/newton.py).

Convergence status is returned as data and, by default, failure raises
(`config.error_on_nonconvergence`): the silent default of the FEniCSx
code the JAX package rebuilt is deliberately not replicated."""

from __future__ import annotations

import torch

from ..config import config
from ..utils.logging import log


def newton_solve(residual_fn, linear_solve_fn, u0, atol=1e-10, rtol=1e-10,
                 max_it=20, report=None, error_on_nonconvergence=None):
    """Solve R(u) = 0.

    residual_fn(u) -> r; linear_solve_fn(u, r) -> du solving J(u) du = r
    (the update is u - du). A host loop: one residual norm is read per
    iteration. Returns (u, info) with info = dict(iters, resnorm,
    converged)."""
    report = config.report if report is None else report
    err = (config.error_on_nonconvergence if error_on_nonconvergence is None
           else error_on_nonconvergence)
    u = u0
    r = residual_fn(u)
    r0 = float(torch.linalg.norm(r))
    rn = r0
    it = 0
    converged = rn <= atol
    while not converged and it < max_it:
        u = u - linear_solve_fn(u, r)
        r = residual_fn(u)
        rn = float(torch.linalg.norm(r))
        it += 1
        if report:
            log(f"Newton it {it}: |r| = {rn:.3e}")
        converged = rn <= atol or rn <= rtol * max(r0, 1e-300)
    info = {"iters": it, "resnorm": rn, "converged": converged}
    if not converged and err:
        raise RuntimeError(
            f"Newton failed to converge: it={it} |r|={rn:.3e} "
            f"(|r0|={r0:.3e})")
    return u, info
