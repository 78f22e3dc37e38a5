"""Setup-time mesh topology for generic meshes (host numpy): the numpy paths
of femo_alpha_tpu/native/topology.py::build_edges and ::build_csr_pattern
(identical semantics), and its reverse Cuthill-McKee ordering written out
in Python."""

from __future__ import annotations

from collections import deque

import numpy as np


def build_edges(conn, local_edges):
    """(edges (n_e,2), cell_edges (nc, n_le), counts (n_e,)) — unique edges
    with sorted vertex pairs in lexicographic order."""
    conn = np.ascontiguousarray(conn, dtype=np.int32)
    le = np.ascontiguousarray(local_edges, dtype=np.int32)
    nc = conn.shape[0]
    n_le = le.shape[0]
    pairs = np.sort(conn[:, le].reshape(-1, 2), axis=1)  # (nc*n_le, 2)
    # one int64 key per sorted pair orders the pairs lexicographically:
    # a 1-D unique, many times faster than unique(axis=0) on the rows
    n = np.int64(max(int(conn.max(initial=0)) + 1, 1))
    key = pairs[:, 0].astype(np.int64) * n + pairs[:, 1]
    uniq, inv, counts = np.unique(key, return_inverse=True,
                                  return_counts=True)
    return (
        np.stack([uniq // n, uniq % n], axis=1).astype(np.int32),
        inv.reshape(nc, n_le).astype(np.int32),
        counts.astype(np.int32),
    )


def build_csr_pattern(dofmap, n_dofs):
    """(order, seg, rows, cols) of the CSR pattern of the dofmap product
    graph, as the reference's native build_csr_pattern returns them: the
    flat entries c*nd*nd + i*nd + j of the element matrices sorted by
    (row, col) key, ties in entry order (order); the distinct (row, col)
    slot of each sorted entry (seg); and the distinct pairs, row-major
    (rows, cols). All int32."""
    dofmap = np.ascontiguousarray(dofmap, dtype=np.int32)
    nd = dofmap.shape[1]
    rows = np.repeat(dofmap, nd, axis=1).reshape(-1)
    cols = np.tile(dofmap, (1, nd)).reshape(-1)
    key = rows.astype(np.int64) * n_dofs + cols
    order = np.argsort(key, kind="stable")
    uniq, seg = np.unique(key[order], return_inverse=True)
    return (order.astype(np.int32), seg.astype(np.int32),
            (uniq // n_dofs).astype(np.int32),
            (uniq % n_dofs).astype(np.int32))


def rcm_order(edges, n_nodes):
    """Reverse Cuthill-McKee permutation (new -> old) of the node graph.

    The loop of the reference's native rcm_order
    (femo_alpha_tpu/native/meshops.cpp): adjacency lists in edge order, a
    breadth-first search from the lowest unvisited node of each component,
    each node's unvisited neighbours appended by increasing degree (ties in
    adjacency order), then the whole order reversed. Its std::sort of a
    list of at most 16 neighbours is an insertion sort, hence stable, so for
    shell meshes (node degree far below 16) this gives the same
    permutation, and the same band, as the reference."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    deg = np.bincount(edges.ravel(), minlength=n_nodes)
    # adjacency of node a in edge order: both endpoints of every edge, the
    # entries of one node kept in the order their edges come
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    which = np.concatenate([np.arange(len(edges)), np.arange(len(edges))])
    order = np.lexsort((which, src))
    adj = dst[order].tolist()
    off = np.concatenate([[0], np.cumsum(deg)]).tolist()
    degl = deg.tolist()
    seen = [False] * n_nodes
    out = []
    for start in range(n_nodes):
        if seen[start]:
            continue
        seen[start] = True
        out.append(start)
        q = deque([start])
        while q:
            v = q.popleft()
            nb = [u for u in adj[off[v]:off[v + 1]] if not seen[u]]
            nb.sort(key=degl.__getitem__)
            for u in nb:
                seen[u] = True
                out.append(u)
                q.append(u)
    return np.asarray(out[::-1], dtype=np.int32)
