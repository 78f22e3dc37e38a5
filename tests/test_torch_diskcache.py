"""The port's disk cache of affine design bases
(femo_alpha_tpu_torch/utils/diskcache.py, CachedAffineAssembler.prepare)
on the CPU: off by default; with FEMO_SETUP_CACHE=1 a second model on the
same inputs loads every basis the first one built, bit for bit, and gives
the same bits; the key parts for each form option the JAX package's key
leaves out (inplane_deg, shear_deg), for the probe scale and for a cell
range; store / load round-trip arrays as the JAX package's module does."""

import os

import numpy as np
import pytest
import torch

from femo_alpha_tpu.utils import diskcache as ref_diskcache

from femo_alpha_tpu_torch.assembly import affine
from femo_alpha_tpu_torch.assembly.affine import CachedAffineAssembler
from femo_alpha_tpu_torch.mesh import createRectangleMesh
from femo_alpha_tpu_torch.models import RMShellModel
from femo_alpha_tpu_torch.models.rm_shell.pde import RMShellPDE
from femo_alpha_tpu_torch.parallel import CellShardSpec, DeviceMesh
from femo_alpha_tpu_torch.utils import diskcache


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """The cache on, in a directory of its own; counts basis builds."""
    monkeypatch.setenv("FEMO_SETUP_CACHE", "1")
    monkeypatch.setenv("FEMO_SETUP_CACHE_DIR", str(tmp_path))
    builds = []
    init = affine.AffineDesignOperator.__init__

    def counted(self, *a, **k):
        builds.append(1)
        return init(self, *a, **k)

    monkeypatch.setattr(affine.AffineDesignOperator, "__init__", counted)
    return tmp_path, builds


def _bc(x):
    return x[:, 0] < 1e-12


def _solve(model):
    """Compliance, its thickness gradient and the fine basis."""
    nel, nn = model.nel, model.nn
    f = np.zeros(3 * nn)
    f[2::3] = 2.0
    th = torch.full((nel,), 0.2, dtype=torch.float64, requires_grad=True)
    out = model.evaluate(f, th, np.full(nel, 4.32e8), np.zeros(nel),
                         np.full(nel, 100.0))
    out.compliance.backward()
    emf = model.fea.states["disp_solid"].pde.element_matrices_fn
    return float(out.compliance.detach()), th.grad.numpy(), emf._aff.basis


def _model(nx=32, ny=8):
    mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad", gdim=3)
    return RMShellModel(mesh, shell_bc_func=_bc, element_wise_material=True,
                        PENALTY_BC=False, device="cpu")


def test_cache_is_off_by_default(tmp_path, monkeypatch):
    """Without FEMO_SETUP_CACHE=1 nothing is written or read."""
    monkeypatch.delenv("FEMO_SETUP_CACHE", raising=False)
    monkeypatch.setenv("FEMO_SETUP_CACHE_DIR", str(tmp_path))
    assert not diskcache.enabled()
    _solve(_model(8, 2))
    assert os.listdir(tmp_path) == []


def test_second_model_loads_the_basis_bit_for_bit(cache):
    """A second model on the same inputs builds no basis and gives the
    first one's compliance, gradient and basis bit for bit."""
    path, builds = cache
    J1, g1, B1 = _solve(_model())
    n1 = len(builds)
    assert n1 == 1 and len(os.listdir(path)) == 1
    J2, g2, B2 = _solve(_model())
    assert len(builds) == n1
    assert J1 == J2 and np.array_equal(g1, g2)
    assert torch.equal(B1, B2)


@pytest.mark.parametrize("option", [{"inplane_deg": 2}, {"shear_deg": 2},
                                    {"element_type": "CG1CG1"}])
def test_key_covers_the_form_options(cache, monkeypatch, option):
    """A form that differs from a cached one only in a quadrature degree
    (which the JAX package's key leaves out) or in its element type does
    not load the cached basis: it builds its own, which equals a build
    with the cache off."""
    path, builds = cache
    mesh = createRectangleMesh(8, 2, (0, 0), (10.0, 2.0), "quad", gdim=3)
    p = {"thickness": torch.full((mesh.n_cells,), 0.2, dtype=torch.float64),
         "E": torch.full((mesh.n_cells,), 4.32e8, dtype=torch.float64),
         "nu": torch.zeros(mesh.n_cells, dtype=torch.float64),
         "uhat": torch.zeros(3 * mesh.n_nodes, dtype=torch.float64)}

    def basis(**kw):
        pde = RMShellPDE(mesh, element_wise_material=True, device="cpu",
                         **kw)
        form = pde.make_residual_form()
        q = dict(p, F_solid=torch.zeros(pde.VF.n_dofs, dtype=torch.float64))
        return CachedAffineAssembler(form).prepare(q)

    basis()
    basis(**option)
    assert len(builds) == 2 and len(os.listdir(path)) == 2
    cached = basis(**option)
    assert len(builds) == 2
    monkeypatch.setenv("FEMO_SETUP_CACHE", "0")
    assert torch.equal(cached, basis(**option))


def test_key_covers_probe_scale_and_cell_range(cache):
    """Another probe scale (the design's median) and one rank's cell range
    each make a key of their own."""
    path, builds = cache
    mesh = createRectangleMesh(8, 2, (0, 0), (10.0, 2.0), "quad", gdim=3)
    pde = RMShellPDE(mesh, element_wise_material=True, device="cpu")
    nc = mesh.n_cells

    def prepare(h, view=None):
        asm = CachedAffineAssembler(pde.make_residual_form())
        if view is not None:
            asm.shard(view)
        return asm.prepare({
            "thickness": torch.full((nc,), h, dtype=torch.float64),
            "E": torch.full((nc,), 4.32e8, dtype=torch.float64),
            "nu": torch.zeros(nc, dtype=torch.float64),
            "uhat": torch.zeros(3 * mesh.n_nodes, dtype=torch.float64),
            "F_solid": torch.zeros(pde.VF.n_dofs, dtype=torch.float64)})

    whole = prepare(0.2)
    prepare(0.3)
    view = CellShardSpec(DeviceMesh(None, 2, 1)).cells_of(pde.W)
    part = prepare(0.2, view)
    assert len(builds) == 3 and len(os.listdir(path)) == 3
    assert part.shape[-1] == view.nc and view.cells == (nc // 2, nc)
    assert torch.equal(prepare(0.2, view), part)
    assert torch.equal(prepare(0.2), whole)
    assert len(builds) == 3


def test_store_load_round_trip_matches_reference(cache):
    """store / load give back the stored arrays, as the JAX package's
    utils/diskcache.py does; an unknown key loads None."""
    path, _ = cache
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((3, 4)), rng.integers(0, 9, 5)]
    diskcache.store("affine", "k", arrays)
    ref_diskcache.store("affine", "k", arrays)
    for got in (diskcache.load("affine", "k"),
                ref_diskcache.load("affine", "k")):
        assert len(got) == 2
        assert all(np.array_equal(a, b) for a, b in zip(got, arrays))
    assert diskcache.load("affine", "other") is None
    assert ref_diskcache.load("affine", "other") is None
