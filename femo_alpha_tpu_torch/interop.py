"""Converters from the JAX package's state, given as numpy arrays, to the
port's tensors. Never imports jax: callers hand over `np.asarray(...)` of
the reference's arrays.

Layouts: the JAX package stores element matrices cell-major (nc, nd, nd)
or lane-major (nd, nd, nc), and affine bases as (K, nc, nd, nd) ('cells')
or (K, nd, nd, nc) ('lane'); the port is lane-major throughout.
"""

from __future__ import annotations

import numpy as np
import torch


def to_tensor(a, dtype=torch.float64, device=None):
    """A design or material field (or any array) as a tensor."""
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def element_matrices_to_lane(Ae, layout="cells", dtype=torch.float64,
                             device=None):
    """Element matrices -> lane-major (nd, nd, nc) tensor."""
    Ae = np.asarray(Ae)
    if layout == "cells":
        Ae = np.moveaxis(Ae, 0, -1)
    elif layout != "lane":
        raise ValueError(f"layout {layout!r}")
    return torch.as_tensor(np.array(Ae, order="C"), dtype=dtype,
                           device=device)


def affine_basis_to_lane(B, layout="cells", dtype=torch.float64,
                         device=None):
    """Affine basis (K, nc, nd, nd) or (K, nd, nd, nc) -> lane-major
    (K, nd, nd, nc) tensor."""
    B = np.asarray(B)
    if layout == "cells":
        B = np.moveaxis(B, 1, -1)
    elif layout != "lane":
        raise ValueError(f"layout {layout!r}")
    return torch.as_tensor(np.array(B, order="C"), dtype=dtype,
                           device=device)


def platesim_inputs_to_torch(t_array, f_history, device=None):
    """A reference PlateSim's thickness (num_var,) and nodal force history
    (time_levels, n_f) -> f64 tensors for the port's PlateSim."""
    return (to_tensor(t_array, device=device),
            to_tensor(f_history, device=device))


def mg_bases_to_lane(bases, layout="cells", dtype=torch.float64,
                     device=None):
    """Per-level affine bases of a reference MG hierarchy -> tuple of
    lane-major tensors (None entries stay None)."""
    return tuple(None if b is None else affine_basis_to_lane(
        b, layout, dtype=dtype, device=device) for b in bases)
