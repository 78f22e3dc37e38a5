"""Edge extraction for generic meshes: the numpy path of
femo_alpha_tpu/native/topology.py::build_edges (identical semantics)."""

from __future__ import annotations

import numpy as np


def build_edges(conn, local_edges):
    """(edges (n_e,2), cell_edges (nc, n_le), counts (n_e,)) — unique edges
    with sorted vertex pairs in lexicographic order."""
    conn = np.ascontiguousarray(conn, dtype=np.int32)
    le = np.ascontiguousarray(local_edges, dtype=np.int32)
    nc = conn.shape[0]
    n_le = le.shape[0]
    pairs = conn[:, le]  # (nc, n_le, 2)
    key = np.sort(pairs.reshape(-1, 2), axis=1)
    uniq, inv, counts = np.unique(key, axis=0, return_inverse=True,
                                  return_counts=True)
    return (
        uniq.astype(np.int32),
        inv.reshape(nc, n_le).astype(np.int32),
        counts.astype(np.int32),
    )
