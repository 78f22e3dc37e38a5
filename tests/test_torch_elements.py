"""The CG2CR1 and CG1CG1 shell elements of the port on the CPU, against the
JAX package: the CR1 and P1 element tables and the CR space, the edge
tables of the penalty facet form, each element variant's forms, the
reference's own element tests, and RMShellModel on every route the
reference picks for them (dense, geometric MG, band Cholesky, aggregation
AMG), with the band order and the AMG's aggregation on CG2CR1, and
evaluate_modal.

Inputs are made with numpy (femo_alpha_tpu_torch.benchmarks.
ELEMENT_PLATES / element_inputs and seeded fields) and handed to both
packages; f64 throughout. The element tables, spaces, edge tables, band
order and AMG aggregation are held to the live JAX package (host numpy);
the rest reads digits pinned by tools/elements_reference_digits.py
(tests/reference_digits/elements.npz), made with FEMO_SETUP_CACHE=0 and
FEMO_COMPILE_CACHE=0 and the JAX package's FEMO_* solver flags unset.
Tolerances: the tables, spaces and aggregation at 1e-14 (the same
arithmetic); the forms at 1e-12; state, compliance and mass at 1e-9 on
strong-BC routes and 1e-8 on penalty ones (two f64 solves of the
beta = 1e15 penalty system differ there: the port's 40x8 CG2CR1 band
solve lies 1.6e-9 from the JAX digits in compliance, the JAX package's
own band and dense solves of that plate 6.4e-9 in the state and 1.2e-9 in
compliance, tools/elements_reference_digits.py spread); |dJ/dh| at 1e-8 and dJ/dh per cell at 1e-6 of its largest entry;
CG iterations as the test of the routes says; the reference test's own
tip bars (2e-3 and 5e-3 of Euler-Bernoulli, below half of it when
locked)."""

import os

import numpy as np
import pytest
import torch

from femo_alpha_tpu.assembly.facets import EdgeTables as RefEdgeTables
from femo_alpha_tpu.elements import tabulate as ref_tabulate
from femo_alpha_tpu.elements.quadrature import quadrature_rule as ref_rule
from femo_alpha_tpu.mesh import createRectangleMesh as ref_rect
from femo_alpha_tpu.solvers.amg import AggregationAMG as RefAMG
from femo_alpha_tpu.solvers.band import (
    nodal_dof_permutation as ref_permutation,
)
from femo_alpha_tpu.spaces import FunctionSpace as RefSpace
from femo_alpha_tpu.spaces import MixedSpace as RefMixed
from femo_alpha_tpu.spaces import locate_dofs_geometric as ref_locate

from femo_alpha_tpu_torch.assembly.assemble import (
    assemble_residual,
    assemble_scalar,
    element_matrices,
)
from femo_alpha_tpu_torch.assembly.facets import EdgeTables
from femo_alpha_tpu_torch.benchmarks import (
    ELEMENT_PLATES,
    MG_PASS_SLACK,
    cg_passes_agree,
    element_inputs,
    element_plate,
)
from femo_alpha_tpu_torch.elements import reference_element, tabulate
from femo_alpha_tpu_torch.elements.quadrature import quadrature_rule
from femo_alpha_tpu_torch.mesh import createRectangleMesh
from femo_alpha_tpu_torch.models import RMShellModel
from femo_alpha_tpu_torch.models.rm_shell.pde import RMShellPDE
from femo_alpha_tpu_torch.solvers.amg import AggregationAMG
from femo_alpha_tpu_torch.solvers.band import nodal_dof_permutation
from femo_alpha_tpu_torch.spaces import (
    FunctionSpace,
    MixedSpace,
    locate_dofs_geometric,
)

REF_NPZ = os.path.join(os.path.dirname(__file__), "reference_digits",
                       "elements.npz")
E_VAL, H, W_PLATE, L_PLATE = 4.32e8, 0.2, 2.0, 10.0
F_D = 10.0 * H
EB_TIP = F_D * W_PLATE * L_PLATE ** 4 / (8 * E_VAL * (W_PLATE * H ** 3 / 12))


def _bc(x):
    return x[:, 0] < 1e-12


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                      dtype=np.float64)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work (the tests run
    beside other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def digits():
    with np.load(REF_NPZ) as z:
        return {k: z[k] for k in z.files}


# ------------------------------------------------------------ tables, space

@pytest.mark.parametrize("family,cell,degree,quad", [
    ("CR", "triangle", 1, 4), ("CR", "triangle", 1, 1),
    ("P", "quad", 1, 0), ("P", "quad", 1, 1), ("P", "quad", 1, 2),
    ("P", "triangle", 2, 4)])
def test_element_tables_match_reference(family, cell, degree, quad):
    """CR1 on triangles (one dof per edge: entity dofs (0, 1, 0), nodes at
    the edge midpoints) and P1 on quads at the quadrature degrees 0-2 of
    the reduced rules, tabulated at the JAX package's points: the rules,
    entity-dof layouts, node coordinates, values and reference gradients
    at 1e-14."""
    pts, w = quadrature_rule(cell, quad)
    rpts, rw = ref_rule(cell, quad)
    assert np.array_equal(pts, rpts) and np.array_equal(w, rw)
    t = tabulate(family, cell, degree, points=pts, weights=w)
    r = ref_tabulate(family, cell, degree, points=rpts, weights=rw)
    assert t.element.entity_dofs == r.element.entity_dofs
    assert np.array_equal(t.element.node_coords, r.element.node_coords)
    for k in ("phi", "dphi", "geom_dphi"):
        assert np.abs(getattr(t, k) - getattr(r, k)).max() <= 1e-14, k
    if family == "CR":
        assert t.element.entity_dofs == (0, 1, 0)
        # each basis function is 1 at its own edge midpoint, 0 at the others
        nodes = t.element.node_coords
        assert np.abs(reference_element("CR", cell, 1).tabulate(nodes, 0)
                      - np.eye(3)).max() <= 1e-14


def test_cr_space_matches_reference():
    """FunctionSpace(mesh, "CR", 1, value_size=3) on a triangle mesh: dofs
    on the edges only, its dofmap, its dof coordinates at the edge
    midpoints and locate_dofs_geometric on it equal the JAX package's; the
    P1 vector space of CG1CG1 takes the structured slice layout, whose
    gather and scatter equal the dofmap's."""
    mesh = createRectangleMesh(6, 3, (0, 0), (10.0, 2.0), "triangle", gdim=3)
    rmesh = ref_rect(6, 3, (0, 0), (10.0, 2.0), "triangle", gdim=3)
    V, R = FunctionSpace(mesh, "CR", 1, 3), RefSpace(rmesh, "CR", 1, 3)
    assert V.n_dofs == R.n_dofs == 3 * mesh.n_edges
    assert np.array_equal(V.dofmap, np.asarray(R.dofmap))
    mid = np.asarray(mesh.coords)[np.asarray(mesh.edges)].mean(axis=1)
    assert np.abs(V.dof_coords - mid).max() <= 1e-14
    assert np.array_equal(V.dof_coords, np.asarray(R.dof_coords))
    for comp in (None, 2):
        assert np.array_equal(locate_dofs_geometric(V, _bc, comp),
                              np.asarray(ref_locate(R, _bc, comp)))
    q = createRectangleMesh(6, 3, (0, 0), (10.0, 2.0), "quad", gdim=3)
    P1 = FunctionSpace(q, "P", 1, 3)
    assert P1._layout is not None and P1._layout.kind == "P1"
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(P1.n_dofs))
    dm = torch.as_tensor(P1.dofmap, dtype=torch.int64)
    assert torch.equal(P1.gather(x), x[dm])
    cv = torch.as_tensor(np.random.default_rng(2).standard_normal(
        tuple(dm.shape)))
    want = torch.zeros(P1.n_dofs, dtype=torch.float64).index_add_(
        0, dm.reshape(-1), cv.reshape(-1))
    assert torch.allclose(P1.scatter_add(cv), want, rtol=1e-14, atol=0.0)


@pytest.mark.parametrize("local_id", [0, 1, 2])
def test_edge_tables_match_reference(local_id):
    """The penalty facet form's edge tables on each local edge of a
    triangle for CG2CR1's families (P2 displacement, CR1 rotation), at the
    form's 1D rule: points, weights and both families' values and
    gradients at 1e-14."""
    fam = [("P", 2), ("CR", 1)]
    t = EdgeTables("triangle", local_id, 4, fam)
    r = RefEdgeTables("triangle", local_id, 4, fam)
    assert np.array_equal(t.points, r.points)
    assert np.array_equal(t.dxi_dt, r.dxi_dt)
    for key in fam:
        for a, b in zip(t.tabs[key], r.tabs[key]):
            assert np.abs(a - b).max() <= 1e-14


# ------------------------------------------------------------------ forms

def _form_case(key):
    cell, et, ideg, sdeg = {"cr": ("triangle", "CG2CR1", 4, 4),
                            "cg1": ("quad", "CG1CG1", 4, 4),
                            "cg1r": ("quad", "CG1CG1", 2, 1)}[key]
    mesh = createRectangleMesh(4, 2, (0, 0), (10.0, 2.0), cell, gdim=3)
    pde = RMShellPDE(mesh, element_wise_material=True, element_type=et,
                     inplane_deg=ideg, shear_deg=sdeg, device="cpu")
    rng = np.random.default_rng(5)
    nel, nn, n = mesh.n_cells, mesh.n_nodes, pde.W.n_dofs
    th = 0.2 * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, nel))
    E = 4.32e8 * (1.0 + 0.1 * rng.uniform(-1.0, 1.0, nel))
    nu = 0.3 + 0.02 * rng.uniform(-1.0, 1.0, nel)
    rho = 100.0 * (1.0 + 0.1 * rng.uniform(-1.0, 1.0, nel))
    uhat = 1e-2 * rng.standard_normal(3 * nn)
    f = np.zeros(3 * nn)
    f[2::3] = 2.0
    u = 1e-3 * rng.standard_normal(n)
    t = {k: torch.as_tensor(v) for k, v in dict(
        thickness=th, E=E, nu=nu, rho=rho, uhat=uhat, F_solid=f, u=u).items()}
    return mesh, pde, t


@pytest.mark.parametrize("key", ["cr", "cg1", "cg1r"])
def test_element_forms_match_reference_digits(key, digits):
    """RMShellPDE(element_type=...) for CG2CR1 (P2 x CR1, nd 27), CG1CG1
    fully integrated and with inplane_deg 2 / shear_deg 1 (nd 24) on the
    4x2 plate at seeded inputs, moved by a small uhat: the public
    attributes, the cell and penalty facet element matrices, the residual
    at a seeded state, the compliance, mass, volume, elastic energy and
    p-norm stress there and the DG1 von Mises projection, against the JAX
    package's at 1e-12."""
    mesh, pde, t = _form_case(key)
    want_nd = {"cr": 27, "cg1": 24, "cg1r": 24}[key]
    assert pde.W.nd_local == want_nd
    assert (pde.element_type, pde.rot_fam, pde.rot_deg, pde.disp_deg) == {
        "cr": ("CG2CR1", "CR", 1, 2), "cg1": ("CG1CG1", "P", 1, 1),
        "cg1r": ("CG1CG1", "P", 1, 1)}[key]
    p = {k: t[k] for k in ("thickness", "E", "nu", "uhat", "F_solid")}
    q = {k: v for k, v in p.items() if k != "F_solid"}
    u = t["u"]
    zero = torch.zeros_like(u)
    d = {k[len(f"form_{key}_"):]: v for k, v in digits.items()
         if k.startswith(f"form_{key}_")}
    assert _rel(element_matrices(pde.make_residual_form(), zero, p),
                d["Ae"]) <= 1e-12
    facet = pde.make_penalty_facet_form(_bc)
    assert _rel(facet.element_ops(zero, {"uhat": t["uhat"]}).permute(
        2, 0, 1), d["facet_Ae"]) <= 1e-12
    assert _rel(assemble_residual(pde.make_residual_form(), u, p),
                d["residual"]) <= 1e-12
    scal = {"compliance": (pde.compliance_form(), u,
                           {"thickness": t["thickness"], "uhat": t["uhat"]}),
            "mass": (pde.mass_form(), t["thickness"],
                     {"density": t["rho"], "uhat": t["uhat"]}),
            "volume": (pde.volume_form(), t["thickness"],
                       {"uhat": t["uhat"]}),
            "elastic_energy": (pde.elastic_energy_form(), u, q),
            "pnorm_stress": (pde.pnorm_stress_form(), u, q)}
    for name, (form, arg, prm) in scal.items():
        got = float(assemble_scalar(form, arg, prm))
        assert abs(got / float(d[name]) - 1.0) <= 1e-12, name
    project, _ = pde.von_mises_dg1_projection()
    assert _rel(project(u, q), d["stress_dg1"]) <= 1e-12


def test_cg2cr1_needs_triangles():
    """CG2CR1 is triangles-only, as in the reference; an unknown element
    type raises."""
    q = createRectangleMesh(4, 2, (0, 0), (10.0, 2.0), "quad", gdim=3)
    with pytest.raises(ValueError, match="triangles-only"):
        RMShellPDE(q, element_type="CG2CR1", device="cpu")
    with pytest.raises(ValueError, match="CG3"):
        RMShellPDE(q, element_type="CG3", device="cpu")


# ---------------------------------------------------- models, every route

def _route(model):
    pde = model.fea.states["disp_solid"].pde
    if pde.solver_opts.get("method") == "dense":
        return "dense"
    return type(pde._pc).__name__


def _evaluate(model, mesh, design, rho=None):
    f, th, E, nu, rho_ = element_inputs(mesh, design)
    if rho is not None:
        rho_ = np.full_like(rho_, rho)
    tht = torch.as_tensor(th).requires_grad_(True)
    out = model.evaluate(f, tht, E, nu, rho_)
    out.compliance.backward()
    pde = model.fea.states["disp_solid"].pde
    passes = [] if _route(model) == "dense" else [
        pde.last_info[k]["passes"] for k in ("forward", "adjoint")]
    return out, tht.grad, passes


def _check_digits(key, out, g, digits, penalty):
    """State, compliance and mass at 1e-9 (1e-8 on a penalty system),
    |dJ/dh| at 1e-8 and dJ/dh per cell at 1e-6 of its largest entry."""
    d = {k[len(key) + 1:]: v for k, v in digits.items()
         if k.startswith(key + "_")}
    bar = 1e-8 if penalty else 1e-9
    assert _rel(out.disp_solid, d["u"]) <= bar
    for k in ("compliance", "mass"):
        assert abs(float(getattr(out, k).detach()) / float(d[k]) - 1.0) \
            <= bar, k
    assert abs(float(torch.linalg.norm(g)) / float(d["grad_norm"]) - 1.0) \
        <= 1e-8
    assert np.abs(_np(g) - d["grad"]).max() <= 1e-6 * np.abs(d["grad"]).max()
    return d


@pytest.mark.parametrize("key", ["cr20", "cg1_20_locked", "cg1_20_fixed"])
def test_reference_element_tests(key, digits):
    """The reference's tests/test_rm_shell.py element cases on the port:
    the 20x4 plate with penalty BCs (the dense route; f_z = 10 h, h = 0.2,
    E = 4.32e8, nu = 0, rho = 1): CG2CR1 on triangles within 2e-3 of the
    Euler-Bernoulli tip, CG1CG1 fully integrated locking below half of it,
    CG1CG1 with inplane_deg 2 / shear_deg 1 within 5e-3 of it (the bars of
    test_cantilever_tip_deflection_vs_euler_bernoulli and
    test_cg1cg1_reduced_shear_beats_locking); state, compliance, mass and
    dJ/dh against the JAX digits (made with the setup cache off: with it
    on, the reference's reduced-shear model reloads the locked model's
    basis), and disp_extracted's largest deflection equal to the state's."""
    name = "elements_cr" if key == "cr20" else "elements_cg1"
    kw = {"cg1_20_locked": dict(PENALTY_BC=True, inplane_deg=4,
                                shear_deg=4),
          "cg1_20_fixed": dict(PENALTY_BC=True)}.get(key, {})
    (_, _, cell), base = ELEMENT_PLATES[name]
    mesh = createRectangleMesh(20, 4, (0, 0), (L_PLATE, W_PLATE), cell,
                               gdim=3)
    model = RMShellModel(mesh, shell_bc_func=_bc, element_wise_material=True,
                         device="cpu", **{**base, **kw})
    assert _route(model) == "dense"
    out, g, _ = _evaluate(model, mesh, 0, rho=1.0)
    tip = float(out.disp_solid.detach().max())
    if key == "cr20":
        assert abs(tip - EB_TIP) / EB_TIP < 2e-3
    elif key == "cg1_20_locked":
        assert tip < 0.5 * EB_TIP
    else:
        assert abs(tip - EB_TIP) / EB_TIP < 5e-3
    assert abs(float(out.disp_extracted[:, 2].detach().max()) - tip) < 1e-14
    d = _check_digits(key, out, g, digits, penalty=True)
    assert abs(tip / float(d["tip"]) - 1.0) <= 1e-8


def test_cg1cg1_moves_with_shear_degree():
    """The port's CG1CG1 plate (20x4, dense, inplane_deg 2) with the
    shear rule of degree 4 (3x3 Gauss points: it locks) and of degree 1
    (one point: it does not): two distinct solves, the one-point tip more
    than twice the other and near Euler-Bernoulli (the JAX package's setup
    cache returned the locked tip for both)."""
    mesh = createRectangleMesh(20, 4, (0, 0), (L_PLATE, W_PLATE), "quad",
                               gdim=3)
    tips = {}
    for sdeg in (4, 1):
        model = RMShellModel(mesh, shell_bc_func=_bc,
                             element_wise_material=True,
                             element_type="CG1CG1", inplane_deg=2,
                             shear_deg=sdeg, device="cpu")
        assert model.shell_pde._rules["shear"]["w"].shape[0] == \
            {4: 9, 1: 1}[sdeg]
        f, th, E, nu, _ = element_inputs(mesh, 0)
        tips[sdeg] = float(model.evaluate(f, th, E, nu, np.ones_like(th))
                           .disp_solid.max())
    assert tips[4] < 0.5 * EB_TIP < 2.0 * tips[4] < tips[1]
    assert abs(tips[1] - EB_TIP) / EB_TIP < 5e-3


@pytest.mark.parametrize("key", ["cg1_mg64", "cg1_band64", "cr_band40",
                                 "cg1_amg64"])
def test_routes_match_reference_digits(key, digits, monkeypatch):
    """RMShellModel on each non-dense route the reference's rules pick for
    the new elements, at element_inputs' design 1 (a smooth per-cell
    thickness), evaluate + compliance backward from zero: CG1CG1 with
    reduced shear on the 64x16 plate (6,630 dofs) with the strong clamp
    (geometric MG on two levels, each with its affine basis), with penalty
    BCs (the band Cholesky) and with the band memory guard forced low
    (FEMO_BAND_MEM_GB=0.000001 at construction: the aggregation AMG); and
    CG2CR1 on the 40x8 triangle plate (7,155 dofs, penalty BCs, the band
    Cholesky). The reference's preconditioner, the state, compliance, mass
    and dJ/dh against the JAX digits; the CG passes of each solve against
    the JAX runs' (on 8 threads and pinned to one core): on MG, where
    both passes follow rounding (the restart starts from the true
    residual at the f64 evaluation floor: the JAX package itself takes 3
    to 5 there at 64x16), within their span widened by
    benchmarks.MG_PASS_SLACK; on the band equal to theirs; on the AMG each
    solve's iterations within 3 % of the nearer JAX run's (the JAX
    package's own adjoint takes 512 on 8 threads, 476 on one core)."""
    name, nx, ny, kw = {
        "cg1_mg64": ("elements_cg1", 64, 16, {}),
        "cg1_band64": ("elements_cg1", 64, 16, dict(PENALTY_BC=True)),
        "cg1_amg64": ("elements_cg1", 64, 16, dict(PENALTY_BC=True)),
        "cr_band40": ("elements_cr", 40, 8, {})}[key]
    (_, _, cell), base = ELEMENT_PLATES[name]
    mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), cell, gdim=3)
    if key == "cg1_amg64":
        monkeypatch.setenv("FEMO_BAND_MEM_GB", "0.000001")
    model = RMShellModel(mesh, shell_bc_func=_bc, element_wise_material=True,
                         device="cpu", **{**base, **kw})
    monkeypatch.delenv("FEMO_BAND_MEM_GB", raising=False)
    assert model.shell_pde.W.n_dofs == int(digits[f"{key}_n_dofs"])
    assert _route(model) == str(digits[f"{key}_precond"])
    pde = model.fea.states["disp_solid"].pde
    assert pde.element_matrices_fn is not None
    if key == "cg1_mg64":
        assert len(model.mg.levels) == 2
        assert all("affine_asm" in lev for lev in model.mg.levels)
    out, g, passes = _evaluate(model, mesh, 1)
    _check_digits(key, out, g, digits, model.PENALTY_BC)
    runs = [digits[f"{key}_cg_passes"], digits[f"{key}_cg_passes_one_core"]]
    if key == "cg1_amg64":
        # each solve's iterations within 3 % of the nearer JAX run's
        for i, n in enumerate(np.sum(passes, axis=1)):
            want = [int(r[i].sum()) for r in runs]
            assert min(abs(n - w) / w for w in want) <= 0.03, (passes, runs)
        return
    # on MG both passes follow rounding: within the JAX runs' span widened
    # by MG_PASS_SLACK, the rule chip_smoke.py holds the card to; on the
    # band equal to the JAX runs'
    slack = MG_PASS_SLACK if key == "cg1_mg64" else (0, 0)
    for i, got in enumerate(passes):
        assert cg_passes_agree(got, [r[i] for r in runs], slack), \
            (passes, runs)


def test_band_order_and_amg_aggregation_on_cg2cr1():
    """CG2CR1's rotation dofs sit on edge midpoints, the same distance from
    both endpoints, so the nearest-node maps of the band's RCM order and
    of the AMG's aggregation meet a tie at every CR dof: the port breaks
    it on the same node as the reference. On the 40x8 triangle plate with
    the clamp at x = 0: the band permutation equal to the JAX package's,
    and the aggregate of every dof and the tentative prolongator weights
    of AggregationAMG equal to its (weights at 1e-14)."""
    mesh = createRectangleMesh(40, 8, (0, 0), (10.0, 2.0), "triangle",
                               gdim=3)
    rmesh = ref_rect(40, 8, (0, 0), (10.0, 2.0), "triangle", gdim=3)
    W = MixedSpace(FunctionSpace(mesh, "P", 2, 3),
                   FunctionSpace(mesh, "CR", 1, 3))
    R = RefMixed(RefSpace(rmesh, "P", 2, 3), RefSpace(rmesh, "CR", 1, 3))
    for a, b in zip(nodal_dof_permutation(W), ref_permutation(R)):
        assert np.array_equal(a, np.asarray(b))
    free = np.ones(W.n_dofs)
    clamp = np.concatenate([locate_dofs_geometric(W.subspaces[0], _bc),
                            locate_dofs_geometric(W.subspaces[1], _bc)
                            + W.subspaces[0].n_dofs])
    free[clamp] = 0.0
    amg, ref = AggregationAMG(W, free_mask=free), RefAMG(R, free_mask=free)
    assert amg.n_agg == ref.n_agg
    assert np.array_equal(amg.agg, np.asarray(ref.agg_d))
    wr = np.stack([np.asarray(c) for c in ref.w_cols], axis=1)
    assert np.abs(amg.w - wr).max() <= 1e-14


@pytest.mark.parametrize("key", ["cr", "cg1", "cg1r"])
def test_modal_eigenvalues_match_reference_digits(key, digits):
    """evaluate_modal(n_modes=4, solver="dense") with each element variant
    on the 8x4 plate 2 x 1 (strong clamp at x = 0, h = 0.02, E = 7e10,
    nu = 0.3, rho = 2,700 per cell): the eigenvalues against the JAX
    package's at 1e-8."""
    cell, et, ideg, sdeg = {"cr": ("triangle", "CG2CR1", 4, 4),
                            "cg1": ("quad", "CG1CG1", 4, 4),
                            "cg1r": ("quad", "CG1CG1", 2, 1)}[key]
    mesh = createRectangleMesh(8, 4, (0, 0), (2.0, 1.0), cell, gdim=3)
    model = RMShellModel(mesh, shell_bc_func=_bc, element_wise_material=True,
                         PENALTY_BC=False, element_type=et, inplane_deg=ideg,
                         shear_deg=sdeg, device="cpu")
    nel = mesh.n_cells
    lam = model.evaluate_modal(np.full(nel, 0.02), np.full(nel, 7.0e10),
                               np.full(nel, 0.3), np.full(nel, 2700.0),
                               n_modes=4, solver="dense").eigenvalues
    assert _rel(lam, digits[f"modal_{key}_eigenvalues"]) <= 1e-8


def test_element_plate_builders():
    """benchmarks.element_plate builds the chip configurations at their own
    size (the solver set-up is lazy, so this is cheap on the CPU): CG1CG1
    with reduced shear and the strong clamp on the 256x64 quads, 100,230
    dofs, MG on 4 levels down to 32x8; CG2CR1 with penalty BCs on the
    128x32 triangles, 50,115 P2 and 37,344 CR dofs, the band Cholesky under
    the default band memory guard."""
    mesh, model = element_plate("elements_cg1", device="cpu")
    assert (model.element_type, model.inplane_deg, model.shear_deg,
            model.PENALTY_BC) == ("CG1CG1", 2, 1, False)
    assert (mesh.cell_type, mesh.n_nodes, mesh.n_cells) == \
        ("quad", 16705, 16384)
    assert _route(model) == "ShellMGPrecond"
    assert [lev["space"].n_dofs for lev in model.mg.levels] == \
        [100230, 25542, 6630, 1782]
    mesh, model = element_plate("elements_cr", device="cpu")
    assert (mesh.cell_type, mesh.n_nodes, mesh.n_cells) == \
        ("triangle", 4257, 8192)
    assert model.PENALTY_BC and model.element_type == "CG2CR1"
    assert [s.n_dofs for s in model.shell_pde.W.subspaces] == [50115, 37344]
    assert _route(model) == "BandPrecond"
