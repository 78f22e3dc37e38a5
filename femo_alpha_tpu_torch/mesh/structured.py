"""StructuredQuadMesh: nx x ny quad grid with GRID-ORDERED dof numbering.

TPU-native keystone: random gather/scatter is the bottleneck of unstructured
FEM assembly on TPUs (and the experimental platform plugin additionally
mishandles 1D gather HLO). On a structured grid every dof family (vertices,
x-edges, y-edges, cell dofs) is a C-ordered 2D grid, so cell-dof gathering
becomes SLICING and scatter-add becomes PAD+ADD — zero irregular memory
traffic, fully fusable by XLA, and it vectorizes onto the VPU/MXU.

The reference's benchmark meshes are exactly such plates
(plate_sim.py:555-563: 1x5 ... 80x400 quads), so this fast path covers the
performance-critical workloads while the generic index-based path covers
arbitrary meshes.

Numbering: vertices id = i*(ny+1)+j; x-edges ((i,j)-(i+1,j)) id = i*(ny+1)+j;
y-edges ((i,j)-(i,j+1)) id = i*ny+j (offset after x-edges); cells id = i*ny+j.
Cell (i,j) local edge order matches LOCAL_EDGES['quad']:
e0 bottom=EX(i,j), e1 right=EY(i+1,j), e2 top=EX(i,j+1), e3 left=EY(i,j).
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh
from .generation import _rectangle_mesh_raw


class StructuredQuadMesh(Mesh):
    def __init__(self, nx, ny, p0=(0.0, 0.0), p1=(1.0, 1.0), gdim=2):
        base = _rectangle_mesh_raw(nx, ny, p0, p1, "quad", gdim)
        super().__init__(base.coords, base.conn, "quad")
        self.nx, self.ny = nx, ny
        self.structured = True
        self._build_structured_topology()

    def _build_structured_topology(self):
        nx, ny = self.nx, self.ny
        n_ex = nx * (ny + 1)
        n_ey = (nx + 1) * ny
        self.n_edges = n_ex + n_ey
        I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        I, J = I.ravel(), J.ravel()
        ex = lambda i, j: (i * (ny + 1) + j).astype(np.int32)  # noqa: E731
        ey = lambda i, j: (n_ex + i * ny + j).astype(np.int32)  # noqa: E731
        self.cell_edges = np.stack(
            [ex(I, J), ey(I + 1, J), ex(I, J + 1), ey(I, J)], axis=1
        ).astype(np.int32)
        # edge -> (vmin, vmax) pairs for dof-coordinate generation
        nid = lambda i, j: i * (ny + 1) + j  # noqa: E731
        EXI, EXJ = np.meshgrid(np.arange(nx), np.arange(ny + 1), indexing="ij")
        EYI, EYJ = np.meshgrid(np.arange(nx + 1), np.arange(ny), indexing="ij")
        edges_x = np.stack(
            [nid(EXI.ravel(), EXJ.ravel()), nid(EXI.ravel() + 1, EXJ.ravel())],
            axis=1,
        )
        edges_y = np.stack(
            [nid(EYI.ravel(), EYJ.ravel()), nid(EYI.ravel(), EYJ.ravel() + 1)],
            axis=1,
        )
        self.edges = np.concatenate([edges_x, edges_y], axis=0).astype(np.int32)
        # exterior facets: reuse the generic detector (edge counts) but keep
        # the structured edge numbering
        counts = np.zeros(self.n_edges, dtype=np.int64)
        np.add.at(counts, self.cell_edges.ravel(), 1)
        self.edge_counts = counts
        ext_ids = np.where(counts == 1)[0]
        is_ext = np.isin(self.cell_edges, ext_ids)
        cells, locs = np.nonzero(is_ext)
        self.ext_facet_cell = cells.astype(np.int32)
        self.ext_facet_local = locs.astype(np.int32)
        from .mesh import LOCAL_EDGES

        le = LOCAL_EDGES["quad"]
        self.ext_facet_verts = self.conn[cells][
            np.arange(len(cells))[:, None], le[locs]
        ].astype(np.int32)
        self.n_ext_facets = len(cells)
        self._topology_built = True
