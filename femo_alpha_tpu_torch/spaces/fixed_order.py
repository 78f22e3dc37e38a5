"""Scatter-adds that sum in a fixed order, without atomics.

`index_add_` and `segment_sum` add with atomics on the card, so the same
inputs can give other bits from run to run; every unstructured scatter of
the port (the spaces' scatter_add, the facet residual, the multigrid
setup's assemblies) goes through `fixed_order_scatter` instead. Its plan
sums each target's entries in source order, the order in which
`index_add_` adds them on the CPU, so on the CPU the two give the same
values (only the sign of a zero sum may differ).
"""

from __future__ import annotations

import numpy as np
import torch


def sum_plan(owner, key, target, device):
    """The fixed summation order of a scatter-add onto `target` (int64,
    one target per source entry), cached in `owner._index_cache` per key
    and device: (uniq, inv) with uniq the distinct targets and inv
    (c, len(uniq)) the source positions of each in its column, increasing,
    padded with one past the last source (a zero)."""
    ck = (key, str(device))
    plan = owner._index_cache.get(ck)
    if plan is None:
        target = np.asarray(target, dtype=np.int64).reshape(-1)
        order = np.argsort(target, kind="stable")
        uniq, starts, counts = np.unique(target[order], return_index=True,
                                         return_counts=True)
        inv = np.full((int(counts.max(initial=1)), len(uniq)), len(target),
                      dtype=np.int64)
        rank = np.arange(len(target)) - np.repeat(starts, counts)
        inv[rank, np.repeat(np.arange(len(uniq)), counts)] = order
        plan = owner._index_cache[ck] = (
            torch.as_tensor(uniq, device=device),
            torch.as_tensor(inv, device=device))
    return plan


def fixed_order_scatter(vals, plan, size):
    """out (size, ...) with out[uniq[s]] = the sum of vals[inv[k, s]] over k
    in order: index_add_ without atomics, so the same inputs give the same
    bits on the card. One gather, then one add per row of the plan; out of
    place, so it runs under torch.func transforms."""
    uniq, inv = plan
    src = torch.cat([vals, vals.new_zeros((1,) + vals.shape[1:])])
    terms = src[inv]
    acc = terms[0]
    for k in range(1, inv.shape[0]):
        acc = acc + terms[k]
    return vals.new_zeros((size,) + vals.shape[1:]).index_put((uniq,), acc)


def fixed_order_reduce(vals, plan, size, dim=0):
    """fixed_order_scatter along `dim` of vals for plans many rows deep
    (an aggregate's dofs, a coarse entry's cells): one gather and one
    PyTorch sum over the plan's rows instead of one add per row. The sum
    runs without atomics, so the same inputs give the same bits on the
    card; its order is PyTorch's, not source order, so on the CPU it may
    differ from index_add_ in the last bits."""
    uniq, inv = plan
    vals = vals.movedim(dim, 0)
    src = torch.cat([vals, vals.new_zeros((1,) + vals.shape[1:])])
    acc = src[inv].sum(0)
    out = vals.new_zeros((size,) + vals.shape[1:]).index_put((uniq,), acc)
    return out.movedim(0, dim)
