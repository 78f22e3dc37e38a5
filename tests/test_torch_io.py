"""The port's XDMF/VTU I/O and Recorder on the CPU, against the JAX
package's io/xdmf.py and io/recorder.py: write_xdmf_mesh (inline XML and
HDF5) read back by both readers, read_xdmf_mesh and readFEAMesh(".xdmf")
on tests/data/plate_2_10_quad_10_50.xdmf, write_vtu, XDMFWriter time
series, the Recorder (values given as tensors, skipped inside a torch.func
transform), and RMShellModel(record=True), which stores the flag.

Files written by both packages from the same seeded data must be equal
byte for byte (the XML and VTU text), and their HDF5 datasets equal.
Meshes read back must give equal coordinates and connectivity."""

import os

import h5py
import numpy as np
import pytest
import torch

from femo_alpha_tpu.io import Recorder as RefRecorder
from femo_alpha_tpu.io import XDMFWriter as RefWriter
from femo_alpha_tpu.io import read_xdmf_mesh as ref_read
from femo_alpha_tpu.io import write_vtu as ref_write_vtu
from femo_alpha_tpu.io.xdmf import write_xdmf_mesh as ref_write_xdmf_mesh
from femo_alpha_tpu.mesh import createRectangleMesh as ref_rect

from femo_alpha_tpu_torch.io import (
    Recorder,
    XDMFWriter,
    read_xdmf_mesh,
    write_vtu,
    write_xdmf_mesh,
)
from femo_alpha_tpu_torch.mesh import createRectangleMesh, readFEAMesh
from femo_alpha_tpu_torch.models import RMShellModel

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
RECT = dict(nx=6, ny=3, p0=(0.0, 0.0), p1=(3.0, 1.0), cell_type="triangle",
            gdim=3)


def _same_mesh(a, b):
    assert a.cell_type == b.cell_type
    assert np.array_equal(np.asarray(a.conn), np.asarray(b.conn))
    assert np.array_equal(np.asarray(a.coords), np.asarray(b.coords))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _h5(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.__setitem__(k, np.asarray(v))
                     if isinstance(v, h5py.Dataset) else None)
    return out


@pytest.mark.parametrize("inline", [True, False])
def test_xdmf_mesh_round_trip(tmp_path, inline):
    """write_xdmf_mesh: the same file as the JAX writer's, read back to the
    same mesh by both readers."""
    mesh = createRectangleMesh(**RECT)
    mine, ref = tmp_path / "port" / "m.xdmf", tmp_path / "ref" / "m.xdmf"
    write_xdmf_mesh(str(mine), mesh, inline=inline)
    ref_write_xdmf_mesh(str(ref), ref_rect(**RECT), inline=inline)
    assert _bytes(mine) == _bytes(ref)
    if not inline:
        h, h_r = _h5(tmp_path / "port" / "m.h5"), _h5(tmp_path / "ref" /
                                                      "m.h5")
        assert h.keys() == h_r.keys()
        assert all(np.array_equal(h[k], h_r[k]) for k in h)
    back = read_xdmf_mesh(str(mine))
    _same_mesh(back, ref_read(str(mine)))
    assert np.array_equal(back.conn, mesh.conn)
    assert np.allclose(back.coords, mesh.coords, rtol=0, atol=1e-15)


def test_read_the_repo_plate_mesh():
    """read_xdmf_mesh and readFEAMesh(.xdmf) on the reference's shipped
    plate (HDF5 data), equal to the JAX reader's mesh."""
    path = os.path.join(DATA, "plate_2_10_quad_10_50.xdmf")
    ref = ref_read(path)
    _same_mesh(read_xdmf_mesh(path), ref)
    mesh = readFEAMesh(path)
    _same_mesh(mesh, ref)
    assert (mesh.n_nodes, mesh.n_cells) == (561, 500)
    assert np.array_equal(mesh.input_global_indices, np.arange(561))


def test_write_vtu_matches_reference(tmp_path):
    """write_vtu with point and cell data given as tensors and arrays."""
    mesh = createRectangleMesh(**RECT)
    rng = np.random.default_rng(21)
    u = rng.standard_normal((mesh.n_nodes, 3))
    s = rng.standard_normal(mesh.n_cells)
    mine, ref = tmp_path / "a.vtu", tmp_path / "b.vtu"
    write_vtu(str(mine), mesh, point_data={"u": torch.tensor(u)},
              cell_data={"s": s})
    ref_write_vtu(str(ref), ref_rect(**RECT), point_data={"u": u},
                  cell_data={"s": s})
    assert _bytes(mine) == _bytes(ref)


def test_xdmf_writer_and_recorder_match_reference(tmp_path):
    """XDMFWriter's time series and the Recorder's files, from the same
    values; a value inside torch.func.vmap is not recorded."""
    mesh, rmesh = createRectangleMesh(**RECT), ref_rect(**RECT)
    rng = np.random.default_rng(22)
    steps = [rng.standard_normal((mesh.n_nodes, 2)) for _ in range(2)]
    cells = rng.standard_normal(mesh.n_cells)
    for pkg, writer, out in (("port", XDMFWriter, tmp_path / "w"),
                             ("ref", RefWriter, tmp_path / "rw")):
        with writer(str(out / "ts.xdmf"), mesh if pkg == "port" else rmesh) \
                as w:
            for t, v in enumerate(steps):
                w.write_function("u", torch.tensor(v) if pkg == "port" else v,
                                 time=float(t))
            w.write_function("h", cells, time=1.0, center="Cell")
    assert _bytes(tmp_path / "w" / "ts.xdmf") == \
        _bytes(tmp_path / "rw" / "ts.xdmf")
    h, h_r = _h5(tmp_path / "w" / "ts.h5"), _h5(tmp_path / "rw" / "ts.h5")
    assert h.keys() == h_r.keys()
    assert all(np.array_equal(h[k], h_r[k]) for k in h)

    rec, ref_rec = Recorder(tmp_path / "r", mesh), \
        RefRecorder(tmp_path / "rr", rmesh)
    for v in steps:
        t = torch.tensor(v, requires_grad=True)
        rec.record("disp", t * 1.0)
        torch.func.vmap(lambda row: rec.record("skipped", row) or row)(t)
        ref_rec.record("disp", v)
        rec.step()
        ref_rec.step()
    rec.close()
    ref_rec.close()
    assert "skipped" not in rec.writers
    assert _bytes(tmp_path / "r" / "record_disp.xdmf") == \
        _bytes(tmp_path / "rr" / "record_disp.xdmf")
    h, h_r = _h5(tmp_path / "r" / "record_disp.h5"), \
        _h5(tmp_path / "rr" / "record_disp.h5")
    assert h.keys() == h_r.keys()
    assert all(np.array_equal(h[k], h_r[k]) for k in h)


def test_rm_shell_model_stores_record():
    """RMShellModel(record=True) is accepted and stores the flag, as the
    reference does (it writes nothing itself)."""
    mesh = createRectangleMesh(4, 2, (0, 0), (2.0, 1.0), "quad", gdim=3)
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 0] < 1e-12,
                         element_wise_material=True, PENALTY_BC=False,
                         record=True, device="cpu")
    assert model.record is True
