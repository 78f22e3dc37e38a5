"""Finite-difference total-derivative verification.

Port of femo_alpha_tpu/adjoint/check.py: compares the reverse-mode total
of a scalar output against central finite differences along seeded random
directions.
"""

from __future__ import annotations

import numpy as np
import torch


def check_totals(fn, params, eps=1e-6, directions=3, seed=0, rtol=1e-4,
                 verbose=True):
    """fn: params -> scalar tensor, params a dict of tensors (or one
    tensor). Checks the autograd gradient of fn against central FD along
    `directions` directions drawn from numpy's default_rng(seed), one
    standard normal array per parameter in sorted-key order. Returns the
    largest relative error; raises AssertionError above rtol."""
    single = isinstance(params, torch.Tensor)
    tree = {"": params} if single else dict(params)
    keys = sorted(tree)

    def call(vals):
        return fn(vals[""] if single else vals)

    leaves = {k: tree[k].detach().requires_grad_(True) for k in keys}
    grads = torch.autograd.grad(call(leaves), [leaves[k] for k in keys],
                                allow_unused=True)
    rng = np.random.default_rng(seed)
    max_rel = 0.0
    with torch.no_grad():
        for k_dir in range(directions):
            ds = {k: torch.as_tensor(
                rng.standard_normal(tuple(tree[k].shape)),
                dtype=tree[k].dtype, device=tree[k].device) for k in keys}
            pp = {k: tree[k].detach() + eps * ds[k] for k in keys}
            pm = {k: tree[k].detach() - eps * ds[k] for k in keys}
            fd = (float(call(pp)) - float(call(pm))) / (2 * eps)
            ad = float(sum(torch.sum(g * ds[k]) for k, g in zip(keys, grads)
                           if g is not None))
            rel = abs(fd - ad) / max(abs(fd), abs(ad), 1e-12)
            max_rel = max(max_rel, rel)
            if verbose:
                print(f"check_totals dir {k_dir}: AD={ad:.10e} "
                      f"FD={fd:.10e} rel={rel:.2e}")
    if max_rel > rtol:
        raise AssertionError(
            f"adjoint/FD mismatch: rel err {max_rel:.3e} > {rtol}")
    return max_rel
