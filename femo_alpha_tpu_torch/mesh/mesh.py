"""Mesh: nodes + cells + derived topology (host numpy, computed once).

Copy of femo_alpha_tpu/mesh/mesh.py (numpy only; the JAX package cannot be
imported without jax). Plays the role of dolfinx.mesh.Mesh in the
reference (utils_dolfinx.py:34-172). Index maps are trivial single-process
ranges.
"""

from __future__ import annotations

import numpy as np

# local edge -> (local vertex, local vertex); order matters for facet ids
LOCAL_EDGES = {
    "interval": np.zeros((0, 2), dtype=np.int64),
    "triangle": np.array([[0, 1], [1, 2], [2, 0]], dtype=np.int64),
    "quad": np.array([[0, 1], [1, 2], [2, 3], [3, 0]], dtype=np.int64),
}

_NV = {"interval": 2, "triangle": 3, "quad": 4}


class Mesh:
    def __init__(self, coords, conn, cell_type: str):
        coords = np.asarray(coords, dtype=np.float64)
        if coords.ndim == 1:
            coords = coords.reshape(-1, 1)
        conn = np.asarray(conn, dtype=np.int32)
        assert cell_type in _NV, cell_type
        assert conn.shape[1] == _NV[cell_type], (conn.shape, cell_type)
        self.coords = coords
        self.conn = conn
        self.cell_type = cell_type
        self.n_nodes = coords.shape[0]
        self.n_cells = conn.shape[0]
        self.gdim = coords.shape[1]
        self.rdim = 1 if cell_type == "interval" else 2
        self._topology_built = False
        # interop reorder maps for the CADDEE contract
        # (rm_shell_model.py:398-412): identity by default, set by mesh I/O
        # when an external node/cell ordering exists.
        self.input_global_indices = None  # external node id -> our node id
        self.original_cell_index = None  # our cell id -> external cell id

    # ---------------------------------------------------------- topology
    def _build_topology(self):
        if self._topology_built:
            return
        ct = self.cell_type
        if ct == "interval":
            # facets are vertices
            counts = np.bincount(self.conn.ravel(), minlength=self.n_nodes)
            ext_verts = np.where(counts == 1)[0]
            self.edges = np.zeros((0, 2), dtype=np.int32)
            self.cell_edges = np.zeros((self.n_cells, 0), dtype=np.int32)
            self.n_edges = 0
            # exterior facet = (cell, local vertex 0/1)
            cells, locs = [], []
            for v in ext_verts:
                c, l = np.argwhere(self.conn == v)[0]
                cells.append(c)
                locs.append(l)
            self.ext_facet_cell = np.asarray(cells, dtype=np.int32)
            self.ext_facet_local = np.asarray(locs, dtype=np.int32)
            self.ext_facet_verts = ext_verts.astype(np.int32).reshape(-1, 1)
        else:
            le = LOCAL_EDGES[ct]
            # native C++ edge extraction (numpy fallback inside)
            from ..native import build_edges

            uniq, cell_edges, counts = build_edges(self.conn, le)
            self.edges = uniq  # (n_edges, 2) sorted verts, lex order
            self.n_edges = len(uniq)
            ne_local = le.shape[0]
            self.cell_edges = cell_edges
            self.edge_counts = counts
            # exterior facets: edges with exactly one incident cell
            ext_edge_ids = np.where(counts == 1)[0]
            is_ext_entry = np.isin(cell_edges, ext_edge_ids)
            cells, locs = np.nonzero(is_ext_entry)
            self.ext_facet_cell = cells.astype(np.int32)
            self.ext_facet_local = locs.astype(np.int32)
            # facet vertices in *cell-local orientation* (not sorted), so
            # that outward normals are consistent for CCW cells
            self.ext_facet_verts = self.conn[cells][
                np.arange(len(cells))[:, None], le[locs]
            ].astype(np.int32)
        self.n_ext_facets = len(self.ext_facet_cell)
        self._topology_built = True

    @property
    def topology(self):
        self._build_topology()
        return self

    def exterior_facets(self):
        """(facet_cell, facet_local, facet_verts): all boundary facets."""
        self._build_topology()
        return self.ext_facet_cell, self.ext_facet_local, self.ext_facet_verts

    def boundary_nodes(self):
        self._build_topology()
        return np.unique(self.ext_facet_verts.ravel())

    def facet_incidences(self, edge_ids):
        """ALL (cell, local_edge) incidences of the given edge ids — 2 per
        manifold interior edge, 3+ at non-manifold junctions (rib-stiffened
        wings). Basis of the reference's dS '+'/'-' restrictions
        (linear_shell_model.py:323-333)."""
        self._build_topology()
        mask = np.isin(self.cell_edges, np.asarray(edge_ids))
        cells, locs = np.nonzero(mask)
        return cells.astype(np.int32), locs.astype(np.int32)

    def interior_facets(self, predicate=None):
        """Interior edges (>= 2 incident cells); optionally only those whose
        EVERY vertex satisfies predicate(coords (n, gdim)) -> bool — the
        dolfinx locate_entities rule used by createCustomMeasure
        (utils_dolfinx.py:555-565). Returns (cells, locals) incidences."""
        self._build_topology()
        if self.cell_type == "interval":
            return (np.zeros(0, dtype=np.int32),) * 2
        ids = np.where(self.edge_counts >= 2)[0]
        if predicate is not None:
            vmask = np.asarray(predicate(self.coords)).astype(bool)
            ids = ids[vmask[self.edges[ids]].all(axis=1)]
        return self.facet_incidences(ids)

    def facet_midpoints(self):
        """Midpoint coordinates of exterior facets (for tagging)."""
        self._build_topology()
        return self.coords[self.ext_facet_verts].mean(axis=1)

    def cell_midpoints(self):
        return self.coords[self.conn].mean(axis=1)

    def cell_coords(self):
        """(n_cells, nv, gdim) vertex coordinates per cell."""
        return self.coords[self.conn]

    def __repr__(self):
        return (
            f"Mesh({self.cell_type}, {self.n_nodes} nodes, "
            f"{self.n_cells} cells, gdim={self.gdim})"
        )
