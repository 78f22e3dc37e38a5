"""Built-in structured meshes.

API parity with the reference test-mesh helpers (utils_dolfinx.py:155-172:
createUnitSquareMesh / createRectangleMesh / createIntervalMesh) and
reconstructFEAMesh (utils_dolfinx.py:653-668: rebuild a mesh from raw node /
connectivity arrays, used for CADDEE interop).
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh


def createIntervalMesh(n: int, x0: float = 0.0, x1: float = 1.0) -> Mesh:
    coords = np.linspace(x0, x1, n + 1).reshape(-1, 1)
    conn = np.stack([np.arange(n), np.arange(1, n + 1)], axis=1)
    return Mesh(coords, conn, "interval")


def createRectangleMesh(
    nx: int,
    ny: int,
    p0=(0.0, 0.0),
    p1=(1.0, 1.0),
    cell_type: str = "quad",
    gdim: int = 2,
    structured: bool = True,
) -> Mesh:
    """Structured rectangle mesh of nx*ny quads (or 2*nx*ny triangles).

    For quads this returns a StructuredQuadMesh (grid-ordered dofs: cell-dof
    gather/scatter become slices — the TPU fast path — and the geometric-MG
    preconditioner hierarchy becomes available); pass structured=False for
    the generic index-based Mesh. Triangles are always generic.

    gdim=3 embeds the mesh in 3D with z=0 (used by the shell models, which
    operate on surface meshes embedded in R^3)."""
    if cell_type == "quad" and structured:
        from .structured import StructuredQuadMesh

        return StructuredQuadMesh(nx, ny, p0, p1, gdim=gdim)
    return _rectangle_mesh_raw(nx, ny, p0, p1, cell_type, gdim)


def _rectangle_mesh_raw(nx, ny, p0, p1, cell_type, gdim):
    xs = np.linspace(p0[0], p1[0], nx + 1)
    ys = np.linspace(p0[1], p1[1], ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)
    if gdim == 3:
        coords = np.concatenate([coords, np.zeros((len(coords), 1))], axis=1)

    def nid(i, j):
        return i * (ny + 1) + j

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    I, J = I.ravel(), J.ravel()
    v00, v10, v11, v01 = nid(I, J), nid(I + 1, J), nid(I + 1, J + 1), nid(I, J + 1)
    if cell_type == "quad":
        conn = np.stack([v00, v10, v11, v01], axis=1)  # CCW
        return Mesh(coords, conn, "quad")
    if cell_type == "triangle":
        t1 = np.stack([v00, v10, v11], axis=1)
        t2 = np.stack([v00, v11, v01], axis=1)
        conn = np.concatenate([t1, t2], axis=0)
        return Mesh(coords, conn, "triangle")
    raise ValueError(cell_type)


def createUnitSquareMesh(nx: int, ny: int, cell_type: str = "triangle") -> Mesh:
    return createRectangleMesh(nx, ny, (0, 0), (1, 1), cell_type)


def readFEAMesh(filename, gdim: int = 3) -> Mesh:
    """Read a mesh file by extension: gmsh ASCII v2.2/v4.1 (.msh) or the
    dolfinx-layout XDMF (+HDF5 or inline XML; io/xdmf.py)."""
    name = str(filename)
    if name.endswith(".msh"):
        from ..io.gmsh import read_msh

        return read_msh(name, gdim=gdim)
    if name.endswith(".xdmf"):
        from ..io.xdmf import read_xdmf_mesh

        return read_xdmf_mesh(name)
    raise ValueError(f"unsupported mesh format: {name} (.msh/.xdmf)")


def reconstructFEAMesh(nodes, connectivity, cell_type: str | None = None) -> Mesh:
    """Build a Mesh from raw node coordinates + connectivity, recording the
    external ordering for CADDEE interop (identity here since we keep the
    caller's ordering verbatim)."""
    nodes = np.asarray(nodes, dtype=np.float64)
    connectivity = np.asarray(connectivity, dtype=np.int32)
    if cell_type is None:
        cell_type = {2: "interval", 3: "triangle", 4: "quad"}[connectivity.shape[1]]
    m = Mesh(nodes, connectivity, cell_type)
    m.input_global_indices = np.arange(m.n_nodes, dtype=np.int32)
    m.original_cell_index = np.arange(m.n_cells, dtype=np.int32)
    return m
