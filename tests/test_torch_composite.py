"""Composite CLT laminates and the BOT reference plane of the port on the
CPU, against the JAX package: the CLT data, the reference's own composite
tests (live), the BOT-plane PDE, the laminate on the MG route (its
coarsening on every level), on the band route and in evaluate_modal.

Inputs are made with numpy (femo_alpha_tpu_torch.benchmarks.
composite_laminate, chip_smoke.py's laminate, and seeded fields) and
handed to both packages; f64 throughout; the reference runs with its
FEMO_* solver flags unset (FEMO_MG_F32, FEMO_LANE_MAJOR, FEMO_HOSTLOOP,
FEMO_CG_DF, FEMO_OP_STORAGE). Digits pinned by
tools/composite_reference_digits.py (tests/reference_digits/
composite.npz) stand where the JAX call costs more than ~10 s: the 64x16
MG plate, the 48x8 band plate, the modal plate and the BOT-plane solve.
Tolerances: the CLT data at 1e-14 and the coarsened laminates at 1e-15
(the same arithmetic); the 20x4 dense plates (the reference's tests) at
1e-9 (state, compliance); the BOT plane at 1e-10; the MG and band plates
at 1e-8 (compliance) / 1e-6 (|dJ/dh|) and the same CG iterations, as
chip_smoke.py holds the 128x32 plate, with the adjoint's part of dJ/dh
per cell at 1e-6 of its largest entry; the modal eigenvalues at 1e-8."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from femo_alpha_tpu.mesh import createRectangleMesh as ref_rect
from femo_alpha_tpu.models import RMShellModel as RefModel
from femo_alpha_tpu.models.rm_shell import material as ref_material
from femo_alpha_tpu.models.rm_shell.mg import (
    _coarsen_composite as ref_coarsen,
)

from femo_alpha_tpu_torch.assembly.assemble import (
    assemble_scalar,
    element_matrices,
)
from femo_alpha_tpu_torch.benchmarks import (
    composite_laminate,
    l2_regularization_grad,
)
from femo_alpha_tpu_torch.fea import FEA, FEAModel
from femo_alpha_tpu_torch.mesh import createRectangleMesh
from femo_alpha_tpu_torch.models import CompositeCLT, RMShellModel
from femo_alpha_tpu_torch.models.rm_shell import material
from femo_alpha_tpu_torch.models.rm_shell.mg import (
    _coarsen_composite,
    build_shell_mg,
    strong_bc_dofs,
)
from femo_alpha_tpu_torch.models.rm_shell.pde import RMShellPDE

REF_FLAGS = ("FEMO_MG_F32", "FEMO_LANE_MAJOR", "FEMO_HOSTLOOP", "FEMO_CG_DF",
             "FEMO_OP_STORAGE")
REF_NPZ = os.path.join(os.path.dirname(__file__), "reference_digits",
                       "composite.npz")
E_VAL, NU, H = 4.32e8, 0.0, 0.2


def _bc(x):
    return x[:, 0] < 1e-12


def _rel(a, b):
    """max |a - b| over max |b| (max |a| where b is zero: a symmetric
    laminate's B and the MID plane's are exactly zero)."""
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    den = np.abs(b).max()
    return float(np.abs(a - b).max() / den if den else np.abs(a).max())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work (the tests run
    beside other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_env():
    with pytest.MonkeyPatch.context() as mp:
        for flag in REF_FLAGS:
            mp.delenv(flag, raising=False)
        yield


@pytest.fixture(scope="module")
def digits():
    with np.load(REF_NPZ) as z:
        return {k: z[k] for k in z.files}


def _ref_clt(c):
    return ref_material.CompositeCLT(c.A, c.B, c.D, c.As)


@pytest.mark.parametrize("case", ["from_layup", "mid", "bot"])
def test_clt_data_matches_reference(case):
    """from_layup (the 1-ply, the sandwich, the unsymmetric 2-ply and the
    phase's per-cell laminate) and single_layer_clt on the MID and BOT
    planes at seeded pointwise E, nu, h, against the JAX functions at
    1e-14."""
    if case == "from_layup":
        z3 = [-H / 2, -H / 4, H / 4, H / 2]
        for E_l, nu_l, z in (([E_VAL], [0.3], [-H / 2, H / 2]),
                             ([E_VAL, E_VAL / 10, E_VAL], [0.3] * 3, z3),
                             ([E_VAL, E_VAL / 10], [0.3, 0.25],
                              [-H / 2, 0.0, H / 2])):
            got = CompositeCLT.from_layup(5, E_l, nu_l, z)
            want = ref_material.CompositeCLT.from_layup(5, E_l, nu_l, z)
            for k in ("A", "B", "D", "As"):
                assert _rel(getattr(got, k), getattr(want, k)) <= 1e-14, k
        lam = composite_laminate(createRectangleMesh(
            16, 4, (0, 0), (10.0, 2.0), "quad", gdim=3))
        assert lam.A.shape == (64, 3, 3)
        assert np.abs(lam.B[:, 0, 0]).max() > 0.0 and (lam.B[:, 0, 0] == 0
                                                       ).any()
        return
    rng = np.random.default_rng(6)
    E = 4.32e8 * (1.0 + 0.1 * rng.random((7, 4)))
    nu = 0.3 * rng.random((7, 4))
    h = 0.2 * (1.0 + 0.2 * rng.random((7, 4)))
    got = material.single_layer_clt(*(torch.as_tensor(a) for a in (E, nu, h)),
                                    bot=case == "bot")
    want = ref_material.single_layer_clt(jnp.asarray(E), jnp.asarray(nu),
                                         jnp.asarray(h), bot=case == "bot")
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) <= 1e-14


def _solve(model, mesh):
    nn, nel = mesh.n_nodes, mesh.n_cells
    p = np.zeros((nn, 3))
    p[:, 2] = 10.0 * H
    args = (p, np.full(nel, H), np.full(nel, E_VAL), np.full(nel, NU),
            np.ones(nel))
    if isinstance(model, RefModel):
        return model.evaluate(*(jnp.asarray(a) for a in args))
    return model.evaluate(*args)


def _plate20(clt=None):
    mesh = createRectangleMesh(20, 4, (0, 0), (10.0, 2.0), "quad", gdim=3)
    return mesh, RMShellModel(mesh, shell_bc_func=_bc,
                              element_wise_material=True, composite_clt=clt,
                              device="cpu")


@pytest.mark.parametrize("case", ["one_ply", "sandwich"])
def test_reference_composite_tests(case, ref_env):
    """The reference's tests/test_rm_shell.py composite cases on the 20x4
    plate (penalty BCs, the dense route), in the port and against the live
    JAX model: a 1-ply laminate reproduces the isotropic model (state and
    compliance at 1e-9); a sandwich with stiff faces deflects less than a
    quarter of its soft core alone; the laminate's state and compliance
    equal the JAX model's to 1e-9."""
    mesh, iso = _plate20()
    n = mesh.n_cells
    z = [-H / 2, -H / 4, H / 4, H / 2]
    if case == "one_ply":
        clt = CompositeCLT.from_layup(n, [E_VAL], [NU], [-H / 2, H / 2])
        _, model = _plate20(clt)
        out, out_i = _solve(model, mesh), _solve(iso, mesh)
        assert _rel(out.disp_solid, out_i.disp_solid.detach()) <= 1e-9
        assert abs(float(out.compliance) / float(out_i.compliance) - 1.0) \
            <= 1e-9
    else:
        soft = CompositeCLT.from_layup(n, [E_VAL / 10] * 3, [NU] * 3, z)
        clt = CompositeCLT.from_layup(n, [E_VAL, E_VAL / 10, E_VAL],
                                      [NU] * 3, z)
        _, model = _plate20(clt)
        out = _solve(model, mesh)
        tip_soft = float(_solve(_plate20(soft)[1], mesh).disp_solid.abs()
                         .max())
        assert float(out.disp_solid.abs().max()) < 0.25 * tip_soft
    pde = model.fea.states["disp_solid"].pde
    assert pde.solver_opts["method"] == "dense"
    assert pde.element_matrices_fn is None
    ref = RefModel(ref_rect(20, 4, (0, 0), (10.0, 2.0), "quad", gdim=3),
                   shell_bc_func=_bc, element_wise_material=True,
                   composite_clt=_ref_clt(clt))
    out_r = _solve(ref, mesh)
    assert _rel(out.disp_solid, out_r.disp_solid) <= 1e-9
    assert abs(float(out.compliance) / float(out_r.compliance) - 1.0) <= 1e-9


def _bot_case():
    """The BOT-plane PDE on the 8x2 plate and the seeded inputs of
    tools/composite_reference_digits.py::bot_inputs."""
    mesh = createRectangleMesh(8, 2, (0, 0), (10.0, 2.0), "quad", gdim=3)
    pde = RMShellPDE(mesh, element_wise_material=True, bot_plane=True,
                     device="cpu")
    nn, n = mesh.n_nodes, pde.W.n_dofs
    rng = np.random.default_rng(4)
    th = 0.2 * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, mesh.n_cells))
    E = 4.32e8 * (1.0 + 0.1 * rng.uniform(-1.0, 1.0, mesh.n_cells))
    nu = 0.3 + 0.02 * rng.uniform(-1.0, 1.0, mesh.n_cells)
    u = 1e-3 * rng.standard_normal(n)
    f = np.zeros(3 * nn)
    f[2::3] = 2.0
    p = {"thickness": th, "E": E, "nu": nu, "uhat": np.zeros(3 * nn),
         "F_solid": f}
    return mesh, pde, {k: torch.as_tensor(v) for k, v in p.items()}, \
        torch.as_tensor(u)


@pytest.mark.parametrize("case", ["element_matrices", "energy", "fea_solve",
                                  "mg_levels"])
def test_bot_plane_matches_reference(case, digits):
    """RMShellPDE(bot_plane=True): its element matrices and elastic energy
    at the seeded state, and a dense solve through the port's FEA with its
    residual form (strong clamp at x = 0, f_z = 2) against the JAX
    package's (state and compliance), at 1e-10; build_shell_mg takes the
    plane to every level and assembles them directly (no affine basis:
    B = -h^2/2 C makes the stiffness more than h M1 + h^3 M3)."""
    mesh, pde, p, u = _bot_case()
    if case == "element_matrices":
        Ae = element_matrices(pde.make_residual_form(),
                              torch.zeros(pde.W.n_dofs, dtype=torch.float64),
                              p)
        assert _rel(Ae, digits["bot_Ae"]) <= 1e-10
        return
    if case == "energy":
        q = {k: v for k, v in p.items() if k != "F_solid"}
        e = float(assemble_scalar(pde.elastic_energy_form(), u, q))
        assert abs(e / float(digits["bot_energy"]) - 1.0) <= 1e-10
        mid = RMShellPDE(mesh, element_wise_material=True, device="cpu")
        assert float(assemble_scalar(mid.elastic_energy_form(), u, q)) != e
        return
    if case == "mg_levels":
        m = createRectangleMesh(32, 8, (0, 0), (10.0, 2.0), "quad", gdim=3)
        mg = build_shell_mg(RMShellPDE(m, element_wise_material=True,
                                       bot_plane=True, device="cpu"), _bc,
                            coarsest_cells=64, device="cpu")
        assert len(mg.levels) == 2
        assert not any("affine_asm" in lev for lev in mg.levels)
        return
    fea = FEA(mesh, device="cpu")
    for name, sp in (("thickness", pde.VT), ("F_solid", pde.VF),
                     ("E", pde.VT), ("nu", pde.VT), ("uhat", pde.VU)):
        fea.add_input(name, sp)
    fea.add_state("disp_solid", pde.make_residual_form(),
                  arguments=["thickness", "F_solid", "E", "nu", "uhat"],
                  solver_opts={"method": "dense"})
    fea.add_strong_bc(strong_bc_dofs(pde, _bc), 0.0)
    fea.add_output("compliance", form=pde.compliance_form(),
                   arguments=["disp_solid", "thickness", "uhat"])
    out = FEAModel(fea=[fea]).evaluate(p)
    assert _rel(out.disp_solid, digits["bot_u"]) <= 1e-10
    assert abs(float(out.compliance) / float(digits["bot_compliance"])
               - 1.0) <= 1e-10


def _laminate_plate(nx, ny, penalty):
    mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad", gdim=3)
    model = RMShellModel(mesh, shell_bc_func=_bc, element_wise_material=True,
                         PENALTY_BC=penalty,
                         composite_clt=composite_laminate(mesh),
                         device="cpu")
    nn, nel = mesh.n_nodes, mesh.n_cells
    f = np.zeros((nn, 3))
    f[:, 2] = 2.0
    th = torch.full((nel,), 0.2, dtype=torch.float64, requires_grad=True)
    out = model.evaluate(f, th, np.full(nel, 4.32e8), np.full(nel, 0.3),
                         np.full(nel, 100.0))
    out.compliance.backward()
    pde = model.fea.states["disp_solid"].pde
    passes = [pde.last_info[k]["passes"] for k in ("forward", "adjoint")]
    return model, float(out.compliance.detach()), th.grad, passes


@pytest.mark.parametrize("route", ["mg", "band"])
def test_laminate_plate_matches_reference_digits(route, digits):
    """chip_smoke.py's laminate (composite_laminate: the unsymmetric 2-ply
    at x < 10/3, the sandwich elsewhere) with f_z = 2, h = 0.2,
    E = 4.32e8, nu = 0.3, rho = 100 per cell, evaluate + compliance
    backward: on the MG route at 64x16 (strong clamp, 16,086 dofs, both
    levels assembled directly with their laminates, no affine basis) and
    on the band route at 48x8 (penalty BCs, 6,270 dofs, the smallest plate
    above the dense path), compliance at 1e-8 and |dJ/dh| at 1e-6 from
    the JAX digits, the forward and adjoint CG iterations of each pass
    (the first and the restart) equal to the JAX run's. On a laminate h
    reaches the state only through drilling, so |dJ/dh| is nearly all the
    closed-form L2 regularization (~1e-3 of it is not): the adjoint's part,
    dJ/dh less that term, is held per cell to the JAX run's at 1e-6 of its
    largest entry."""
    key = {"mg": "plate64", "band": "band48"}[route]
    nx, ny = {"mg": (64, 16), "band": (48, 8)}[route]
    model, J, g, passes = _laminate_plate(nx, ny, route == "band")
    pde = model.fea.states["disp_solid"].pde
    assert pde.element_matrices_fn is None
    assert pde.n_dofs == int(digits[f"{key}_n_dofs"])
    if route == "mg":
        assert len(model.mg.levels) == 2
        assert not any("affine_asm" in lev for lev in model.mg.levels)
    else:
        assert getattr(model, "mg", None) is None
        assert model.band is not None
    assert abs(J / float(digits[f"{key}_compliance"]) - 1.0) <= 1e-8
    assert abs(float(torch.linalg.norm(g))
               / float(digits[f"{key}_grad_norm"]) - 1.0) <= 1e-6
    assert passes == digits[f"{key}_cg_passes"].tolist()
    gs = g.numpy() - l2_regularization_grad(model.mesh,
                                            np.full(model.mesh.n_cells, 0.2))
    gs_ref = digits[f"{key}_grad_state"]
    assert np.abs(gs - gs_ref).max() <= 1e-6 * np.abs(gs_ref).max()


@pytest.mark.parametrize("nx,ny", [(64, 16), (128, 32)])
def test_coarsen_composite_matches_reference(nx, ny):
    """The laminate of every MG level (2x2 cell means in _coarsen_dg0's
    order) against the JAX package's _coarsen_composite at 1e-15, for the
    64x16 test plate and the 128x32 plate of chip_smoke.py; the levels'
    PDEs carry them."""
    mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad", gdim=3)
    c = composite_laminate(mesh)
    r = _ref_clt(c)
    k = 0
    while nx % 2 == 0 and ny % 2 == 0 and nx * ny // 4 >= 256:
        c, r = _coarsen_composite(c, nx, ny), ref_coarsen(r, nx, ny)
        nx, ny = nx // 2, ny // 2
        for key in ("A", "B", "D", "As"):
            assert _rel(getattr(c, key), getattr(r, key)) <= 1e-15, key
        k += 1
    assert k == (1 if mesh.nx == 64 else 2)
    # the transition column mixes the two laminates on the coarse levels
    assert len(np.unique(np.round(c.D[:, 0, 0], 6))) >= 3


def test_modal_with_laminate_matches_reference_digits(digits):
    """evaluate_modal(n_modes=4, solver="dense") of the 8x4 plate (2 x 1,
    strong clamp, element-wise E = 7e10, nu = 0.3, h = 0.02, rho = 2,700)
    with its composite_laminate (x_split 2/3): the eigenvalues at 1e-8
    from the JAX digits (the stiffness from the laminate, the mass from
    rho h)."""
    mesh = createRectangleMesh(8, 4, (0, 0), (2.0, 1.0), "quad", gdim=3)
    nel = mesh.n_cells
    clt = composite_laminate(mesh, h=0.02, E=7.0e10, nu=0.3,
                             x_split=2.0 / 3.0)
    model = RMShellModel(mesh, shell_bc_func=_bc, element_wise_material=True,
                         PENALTY_BC=False, composite_clt=clt, device="cpu")
    out = model.evaluate_modal(np.full(nel, 0.02), np.full(nel, 7.0e10),
                               np.full(nel, 0.3), np.full(nel, 2700.0),
                               n_modes=4, solver="dense")
    lam = out.eigenvalues.detach().numpy()
    want = digits["modal_eigenvalues"]
    assert np.abs(lam / want - 1.0).max() <= 1e-8


def test_cell_consts_reach_every_consumer():
    """The laminate rides FemForm.cell_consts into every consumer, sliced
    by cell: element_matrices and assemble_residual in chunks of 5 cells
    equal the unchunked ones to 1e-13, assemble_scalar_subset over every cell
    equals assemble_scalar and over half the cells their own sum, and
    CachedAffineAssembler.direct is the lane-major element_matrices; a
    laminate of the wrong cell count raises."""
    from femo_alpha_tpu_torch.assembly.affine import CachedAffineAssembler
    from femo_alpha_tpu_torch.assembly.assemble import (
        assemble_residual,
        assemble_scalar_subset,
    )

    mesh, _, p, u = _bot_case()
    pde = RMShellPDE(mesh, element_wise_material=True, device="cpu",
                     composite=composite_laminate(mesh, x_split=4.0))
    form = pde.make_residual_form()
    assert set(form.cell_consts) == {"clt_A", "clt_B", "clt_D", "clt_As"}
    Ae = element_matrices(form, u, p)
    # batches of another size round differently: 1e-13, not bits
    assert _rel(element_matrices(form, u, p, chunk=5), Ae) <= 1e-13
    assert _rel(assemble_residual(form, u, p, chunk=5),
                assemble_residual(form, u, p)) <= 1e-13
    q = {k: v for k, v in p.items() if k != "F_solid"}
    eform = pde.elastic_energy_form()
    e = float(assemble_scalar(eform, u, q))
    cells = np.arange(mesh.n_cells)
    assert abs(float(assemble_scalar_subset(eform, u, q, cells)) / e - 1.0) \
        <= 1e-13
    halves = [float(assemble_scalar_subset(eform, u, q, c))
              for c in (cells[::2], cells[1::2])]
    assert abs(sum(halves) / e - 1.0) <= 1e-13
    direct = CachedAffineAssembler(form).direct(None, p)
    assert _rel(direct, element_matrices(form, torch.zeros_like(u), p)
                .permute(1, 2, 0)) <= 1e-13
    with pytest.raises(ValueError, match="cells"):
        RMShellPDE(mesh, element_wise_material=True, device="cpu",
                   composite=CompositeCLT.from_layup(3, [E_VAL], [0.3],
                                                     [-H / 2, H / 2]))
