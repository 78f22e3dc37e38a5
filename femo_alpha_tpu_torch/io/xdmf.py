"""XDMF (+HDF5) and VTU mesh/field output for ParaView, and the XDMF mesh
reader (port of femo_alpha_tpu/io/xdmf.py, the same files).

Time series are written as an XDMF temporal collection backed by one HDF5
file; VTU is a standalone ASCII writer. The reader takes the
Grid/Topology/Geometry layout dolfinx writes, HDF or inline-XML data.
h5py is imported where the JAX module imports it: by XDMFWriter, by
write_xdmf_mesh for HDF data and by read_xdmf_mesh; write_vtu and an
inline write_xdmf_mesh need no h5py. Values may be numpy arrays or
tensors on any device (copied to the host).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

_XDMF_CELL = {"triangle": "Triangle", "quad": "Quadrilateral",
              "interval": "Polyline"}
_VTK_CELL = {"triangle": 5, "quad": 9, "interval": 3}


def _host(values):
    """A numpy array of values (a tensor is detached and copied)."""
    if hasattr(values, "detach"):
        return values.detach().cpu().numpy()
    return np.asarray(values)


class XDMFWriter:
    """Time-series writer: one .xdmf XML + one .h5 payload."""

    def __init__(self, filename, mesh):
        import h5py

        self.filename = str(filename)
        base = os.path.splitext(self.filename)[0]
        self.h5name = base + ".h5"
        os.makedirs(os.path.dirname(os.path.abspath(self.filename)),
                    exist_ok=True)
        self.mesh = mesh
        self.h5 = h5py.File(self.h5name, "w")
        coords = mesh.coords
        if coords.shape[1] == 2:
            coords = np.concatenate(
                [coords, np.zeros((len(coords), 1))], axis=1)
        self.h5.create_dataset("mesh/geometry", data=coords)
        self.h5.create_dataset("mesh/topology", data=mesh.conn)
        self.steps = []  # (time, {name: (center, width)})
        self._closed = False

    def write_function(self, name, values, time=0.0, center="Node"):
        """values: (n_nodes,) / (n_nodes, k) nodal or (n_cells,[k]) cell
        data (center='Cell')."""
        vals = _host(values)
        if vals.ndim == 1:
            vals = vals.reshape(-1, 1)
        step_id = len(self.steps)
        self.h5.create_dataset(f"data/{name}_{step_id}", data=vals)
        if not self.steps or self.steps[-1][0] != time:
            self.steps.append((time, {}))
        self.steps[-1][1][name] = (center, vals.shape[1], step_id)

    def close(self):
        if self._closed:
            return
        self.h5.close()
        h5rel = os.path.basename(self.h5name)
        mesh = self.mesh
        root = ET.Element("Xdmf", Version="3.0")
        dom = ET.SubElement(root, "Domain")
        tgrid = ET.SubElement(dom, "Grid", Name="TimeSeries",
                              GridType="Collection",
                              CollectionType="Temporal")
        nn, nc = mesh.n_nodes, mesh.n_cells
        nv = mesh.conn.shape[1]
        for time, fields in self.steps:
            g = ET.SubElement(tgrid, "Grid", Name="mesh", GridType="Uniform")
            ET.SubElement(g, "Time", Value=str(time))
            topo = ET.SubElement(
                g, "Topology", TopologyType=_XDMF_CELL[mesh.cell_type],
                NumberOfElements=str(nc),
            )
            d = ET.SubElement(topo, "DataItem",
                              Dimensions=f"{nc} {nv}", Format="HDF",
                              NumberType="Int")
            d.text = f"{h5rel}:/mesh/topology"
            geom = ET.SubElement(g, "Geometry", GeometryType="XYZ")
            d = ET.SubElement(geom, "DataItem", Dimensions=f"{nn} 3",
                              Format="HDF")
            d.text = f"{h5rel}:/mesh/geometry"
            for name, (center, width, sid) in fields.items():
                atype = "Scalar" if width == 1 else "Vector"
                att = ET.SubElement(g, "Attribute", Name=name,
                                    AttributeType=atype, Center=center)
                n_items = nn if center == "Node" else nc
                d = ET.SubElement(att, "DataItem",
                                  Dimensions=f"{n_items} {width}",
                                  Format="HDF")
                d.text = f"{h5rel}:/data/{name}_{sid}"
        ET.ElementTree(root).write(self.filename, xml_declaration=True)
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def write_vtu(filename, mesh, point_data=None, cell_data=None):
    """Standalone ASCII VTU writer (ParaView-readable, no dependencies)."""
    coords = mesh.coords
    if coords.shape[1] < 3:
        coords = np.concatenate(
            [coords, np.zeros((len(coords), 3 - coords.shape[1]))], axis=1)
    nn, nc = mesh.n_nodes, mesh.n_cells
    nv = mesh.conn.shape[1]
    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="UnstructuredGrid" version="0.1">',
        "<UnstructuredGrid>",
        f'<Piece NumberOfPoints="{nn}" NumberOfCells="{nc}">',
        "<Points>",
        '<DataArray type="Float64" NumberOfComponents="3" format="ascii">',
        "\n".join(" ".join(f"{v:.16g}" for v in row) for row in coords),
        "</DataArray>", "</Points>", "<Cells>",
        '<DataArray type="Int32" Name="connectivity" format="ascii">',
        "\n".join(" ".join(str(v) for v in row) for row in mesh.conn),
        "</DataArray>",
        '<DataArray type="Int32" Name="offsets" format="ascii">',
        " ".join(str(nv * (i + 1)) for i in range(nc)),
        "</DataArray>",
        '<DataArray type="Int32" Name="types" format="ascii">',
        " ".join(str(_VTK_CELL[mesh.cell_type]) for _ in range(nc)),
        "</DataArray>", "</Cells>",
    ]

    def data_block(data):
        out = []
        for name, vals in (data or {}).items():
            vals = _host(vals)
            ncomp = 1 if vals.ndim == 1 else vals.shape[1]
            out.append(
                f'<DataArray type="Float64" Name="{name}" '
                f'NumberOfComponents="{ncomp}" format="ascii">')
            out.append(
                "\n".join(
                    " ".join(f"{v:.16g}" for v in np.atleast_1d(row))
                    for row in vals))
            out.append("</DataArray>")
        return out

    lines += ["<PointData>"] + data_block(point_data) + ["</PointData>"]
    lines += ["<CellData>"] + data_block(cell_data) + ["</CellData>"]
    lines += ["</Piece>", "</UnstructuredGrid>", "</VTKFile>"]
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, "w") as f:
        f.write("\n".join(lines))


def write_xdmf_mesh(filename, mesh, inline=False):
    """Standalone XDMF mesh file in the dolfinx Grid layout (the format of
    the reference's shipped plate/pav meshes, utils_dolfinx.py:34-50).
    inline=True embeds the data as XML text (no .h5 sidecar)."""
    coords = np.asarray(mesh.coords, dtype=np.float64)
    if coords.shape[1] < 3:
        coords = np.concatenate(
            [coords, np.zeros((len(coords), 3 - coords.shape[1]))], axis=1)
    conn = np.asarray(mesh.conn)
    nn, nc = mesh.n_nodes, mesh.n_cells
    nv = conn.shape[1]
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    root = ET.Element("Xdmf", Version="3.0")
    dom = ET.SubElement(root, "Domain")
    g = ET.SubElement(dom, "Grid", Name="mesh", GridType="Uniform")
    topo = ET.SubElement(g, "Topology",
                         TopologyType=_XDMF_CELL[mesh.cell_type],
                         NumberOfElements=str(nc))
    dt = ET.SubElement(topo, "DataItem", Dimensions=f"{nc} {nv}",
                       NumberType="Int")
    geom = ET.SubElement(g, "Geometry", GeometryType="XYZ")
    dg = ET.SubElement(geom, "DataItem", Dimensions=f"{nn} 3")
    if inline:
        dt.set("Format", "XML")
        dt.text = "\n".join(" ".join(str(v) for v in row) for row in conn)
        dg.set("Format", "XML")
        dg.text = "\n".join(
            " ".join(f"{v:.16g}" for v in row) for row in coords)
    else:
        import h5py

        h5name = os.path.splitext(str(filename))[0] + ".h5"
        with h5py.File(h5name, "w") as f:
            f.create_dataset("Mesh/mesh/topology", data=conn)
            f.create_dataset("Mesh/mesh/geometry", data=coords)
        rel = os.path.basename(h5name)
        dt.set("Format", "HDF")
        dt.text = f"{rel}:/Mesh/mesh/topology"
        dg.set("Format", "HDF")
        dg.text = f"{rel}:/Mesh/mesh/geometry"
    ET.ElementTree(root).write(str(filename), xml_declaration=True)


def read_xdmf_mesh(filename):
    """Minimal XDMF mesh reader for dolfinx-written Grid files (parity with
    readFEAMesh, utils_dolfinx.py:34-50). Returns a Mesh."""
    import h5py

    from ..mesh import Mesh

    tree = ET.parse(filename)
    root = tree.getroot()
    topo = root.find(".//Topology")
    geom = root.find(".//Geometry")
    base = os.path.dirname(os.path.abspath(filename))

    def load(ditem):
        txt = ditem.text.strip()
        if ditem.get("Format", "XML") == "HDF":
            fname, path = txt.split(":")
            with h5py.File(os.path.join(base, fname), "r") as f:
                return np.asarray(f[path])
        dims = [int(x) for x in ditem.get("Dimensions").split()]
        return np.asarray(txt.split(), dtype=np.float64).reshape(dims)

    conn = load(topo.find("DataItem")).astype(np.int32)
    coords = load(geom.find("DataItem"))
    ttype = topo.get("TopologyType", "").lower()
    cell_type = {"triangle": "triangle", "quadrilateral": "quad"}.get(
        ttype, "quad" if conn.shape[1] == 4 else "triangle")
    m = Mesh(coords, conn, cell_type)
    m.input_global_indices = np.arange(m.n_nodes, dtype=np.int32)
    m.original_cell_index = np.arange(m.n_cells, dtype=np.int32)
    return m
