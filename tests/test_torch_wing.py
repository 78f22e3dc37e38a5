"""The default aircraft configuration of the port on the CPU, against the
JAX package: gmsh meshes, generated wings, the penalty facet form
(exterior and interior facets), the stress outputs, and RMShellModel with
penalty BCs, mesh tags and every output on a tiny tagged wing (n_dofs
<= 6000, so both packages take the dense f64 Cholesky path).

Inputs are made with numpy from a seed; f64 throughout. The meshes are
compared with the JAX package's readers and generator live (host numpy);
the forms' and the model's JAX results at the same inputs are pinned in
tests/reference_digits/wing.npz by `tools/wing_reference_digits.py
tests` (the JAX package with its FEMO_* solver flags unset:
FEMO_MG_F32, FEMO_LANE_MAJOR, FEMO_HOSTLOOP, FEMO_CG_DF,
FEMO_OP_STORAGE; with FEMO_COMPILE_CACHE=0). Tolerances: 1e-12
relative for the forms (the same arithmetic in another order), 1e-8 for
the model's outputs (the p-norms, sigma^100, at 100 x 1e-8) and 1e-6 for
its gradient (two dense f64 Cholesky solves of a system with beta = 1e15
penalty rows: the packages' displacements agree to ~2e-10 on it)."""

import os

import numpy as np
import pytest
import torch

from femo_alpha_tpu.mesh import createWingShellMesh as ref_wing
from femo_alpha_tpu.mesh import readFEAMesh as ref_read

from femo_alpha_tpu_torch.assembly.assemble import (
    assemble_scalar,
    assemble_scalar_subset,
)
from femo_alpha_tpu_torch.mesh import createWingShellMesh, readFEAMesh
from femo_alpha_tpu_torch.models import RMShellModel
from femo_alpha_tpu_torch.models.rm_shell.pde import RMShellPDE

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
REF_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "reference_digits", "wing.npz")
MESH_KEYS = ("coords", "conn", "input_global_indices", "original_cell_index")


@pytest.fixture(scope="module")
def ref():
    with np.load(REF_NPZ) as z:
        return {k: z[k] for k in z.files}


def _root(x):
    return np.abs(x[:, 1]) < 1e-9


def _root_and_rib(x):
    """The root section (exterior facets) and the rib station at y = 5
    (interior facets, non-manifold at the rib junction)."""
    return (np.abs(x[:, 1]) < 1e-9) | (np.abs(x[:, 1] - 5.0) < 1e-9)


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _same_mesh(a, b):
    for k in MESH_KEYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    assert sorted(a.cell_tags) == sorted(b.cell_tags)
    for t in a.cell_tags:
        np.testing.assert_array_equal(a.cell_tags[t], b.cell_tags[t])
    assert sorted(a.facet_tags) == sorted(b.facet_tags)
    for t in a.facet_tags:
        np.testing.assert_array_equal(a.facet_tags[t], b.facet_tags[t])
    assert a.physical_names == b.physical_names


@pytest.mark.parametrize("name", ["pav_like_wing_2388.msh",
                                  "c172_like_wing_648.msh"])
def test_read_msh_matches_reference(name):
    path = os.path.join(DATA, name)
    _same_mesh(readFEAMesh(path), ref_read(path))


def test_wing_mesh_matches_reference():
    kw = dict(n_chord=6, n_span=10, rib_stations=(5,), shuffle_seed=3)
    _same_mesh(createWingShellMesh(**kw), ref_wing(**kw))


def test_xdmf_reader_is_not_ported():
    """Once unported, the XDMF reader is now ported: readFEAMesh on the
    reference's shipped plate gives the JAX reader's mesh (the name is
    kept from when this test held the raise)."""
    path = os.path.join(DATA, "plate_2_10_quad_10_50.xdmf")
    mesh, ref = readFEAMesh(path), ref_read(path)
    assert mesh.cell_type == ref.cell_type
    assert np.array_equal(mesh.conn, np.asarray(ref.conn))
    assert np.array_equal(mesh.coords, np.asarray(ref.coords))


def _pde(n_chord, n_span, ribs):
    kw = dict(n_chord=n_chord, n_span=n_span, rib_stations=ribs)
    return RMShellPDE(createWingShellMesh(**kw), element_wise_material=True,
                      device="cpu")


def _params(rng, nel, nn, uhat_scale=0.0):
    return {"thickness": 0.005 * (1 + 0.2 * rng.uniform(size=nel)),
            "E": np.full(nel, 71.7e9), "nu": np.full(nel, 0.33),
            "uhat": uhat_scale * rng.standard_normal(3 * nn)}


def test_penalty_facet_form_matches_reference(ref):
    """Residual and element blocks of the penalty facet energy, on exterior
    (root) and interior (rib station, with its non-manifold junction)
    facets, under a mesh motion uhat: <= 1e-12 relative."""
    pde = _pde(6, 10, (5,))
    mesh = pde.mesh
    ff = pde.make_penalty_facet_form(_root_and_rib)
    n_int = len(mesh.interior_facets(_root_and_rib)[0])
    assert n_int > 0 and len(ff.cells) > n_int
    rng = np.random.default_rng(0)
    u = 1e-3 * rng.standard_normal(pde.W.n_dofs)
    p = {"uhat": 1e-3 * rng.standard_normal(3 * mesh.n_nodes)}
    pt = {k: torch.as_tensor(v) for k, v in p.items()}
    r = ff.assemble_residual(torch.as_tensor(u), pt).numpy()
    assert _rel(r, ref["facet_residual"]) <= 1e-12
    e = float(ff.assemble_scalar(torch.as_tensor(u), pt))
    assert abs(e / float(ref["facet_energy"]) - 1) <= 1e-12
    Ae = ff.element_ops(torch.as_tensor(u), pt).permute(2, 0, 1).numpy()
    np.testing.assert_array_equal(ff.block.dofmap, ref["facet_dofmap"])
    assert _rel(Ae, ref["facet_blocks"]) <= 1e-12


def test_stress_and_scalar_forms_match_reference(ref):
    """p-norm stress (plain, masked and over a cell subset), the von Mises
    DG1 projection, volume, elastic energy and surface area: <= 1e-12."""
    pde = _pde(4, 6, (3,))
    mesh = pde.mesh
    nel, nn = mesh.n_cells, mesh.n_nodes
    rng = np.random.default_rng(1)
    # sigma ~ 1e6 Pa: (m sigma)^rho stays inside f64's range
    u = 1e-5 * rng.standard_normal(pde.W.n_dofs)
    p = _params(rng, nel, nn, uhat_scale=1e-3)
    pt = {k: torch.as_tensor(v) for k, v in p.items()}
    ut = torch.as_tensor(u)
    assert abs(pde.surface_area() / float(ref["surface_area"]) - 1) <= 1e-12
    cells = mesh.cell_tags[2]
    mask = np.zeros(nel)
    mask[cells] = 1.0
    got = [
        assemble_scalar(pde.pnorm_stress_form(), ut, pt),
        assemble_scalar(pde.pnorm_stress_form(cell_mask=mask), ut,
                        {**pt, "_mask": torch.as_tensor(mask)}),
        assemble_scalar_subset(pde.pnorm_stress_form(), ut, pt, cells),
        assemble_scalar(pde.elastic_energy_form(), ut, pt),
        assemble_scalar(pde.volume_form(), pt["thickness"],
                        {"uhat": pt["uhat"]}),
    ]
    for g, want in zip(got, ref["scalar_forms"], strict=True):
        assert abs(float(g) / float(want) - 1) <= 1e-12
    project, V = pde.von_mises_dg1_projection()
    vm = project(ut, pt).numpy()
    assert vm.shape == (V.n_dofs,)
    assert _rel(vm, ref["von_mises_dg1"]) <= 1e-12


# ---------------------------------------------------------------- the model
KW = dict(n_chord=4, n_span=6, rib_stations=(3,))
OUTPUTS = ("disp_solid", "disp_extracted", "compliance", "mass", "volume",
           "elastic_energy", "pnorm_stress", "aggregated_stress", "stress",
           "pnorm_stress_1", "pnorm_stress_2")


def _model_inputs(nel, nn):
    rng = np.random.default_rng(2)
    f = np.zeros((nn, 3))
    f[:, 2] = 4000.0 * (1.0 + 0.1 * rng.standard_normal(nn))
    th = 0.005 * (1.0 + 0.2 * rng.uniform(size=nel))
    return f, th, np.full(nel, 71.7e9), np.full(nel, 0.33), \
        np.full(nel, 2780.0)


@pytest.fixture(scope="module")
def tiny_reference(ref):
    """The JAX package on the tiny tagged wing: every output and the
    gradient of aggregated_stress (pinned)."""
    return {k: ref[f"tiny_{k}"] for k in OUTPUTS}, ref["tiny_grad"]


def test_tiny_wing_model_matches_reference(tiny_reference):
    ref, g_ref = tiny_reference
    mesh = createWingShellMesh(**KW)
    assert mesh.n_cells == 50
    model = RMShellModel(mesh, shell_bc_func=_root,
                         element_wise_material=True,
                         mesh_tags={t: c for t, c in mesh.cell_tags.items()},
                         device="cpu")
    assert model.shell_pde.W.n_dofs <= 6000  # the dense path
    f, th, E, nu, rho = _model_inputs(mesh.n_cells, mesh.n_nodes)
    tt = torch.tensor(th, requires_grad=True)
    out = model.evaluate(f, tt, E, nu, rho)
    for k in OUTPUTS:
        got = getattr(out, k).detach().numpy()
        assert got.shape == np.shape(ref[k]), k
        # a p-norm is sigma^rho (rho = 100): it carries the stress's
        # relative error rho-fold, so it is held at rho * 1e-8
        bar = 100 * 1e-8 if k.startswith("pnorm") else 1e-8
        assert _rel(got, ref[k]) <= bar, (k, _rel(got, ref[k]))
    out.aggregated_stress.backward()
    assert _rel(tt.grad.numpy(), g_ref) <= 1e-6
