"""The JAX package's f32 solver configuration in femo_alpha_tpu_torch on the
CPU, and the cell-major operator API, against the JAX package:

- the f32 geometric-MG hierarchy (FEMO_MG_F32=1: f32 RMShellPDE and f32
  affine bases per level, the V-cycle state in f32) on the 64x16
  strong-BC plate of LibraryBench (16,086 dofs, MG on 2 levels);
- the f32 fine-operator storage (FEMO_OP_STORAGE=f32) on the same plate;
- the f32 band factor with its shift guard on the 8x36 penalty wing of
  tests/test_torch_band.py, and the guard itself on synthetic bands;
- the f32 AMG setup, applied in f64, on the 6x8 wing of
  tests/test_torch_amg.py;
- PlateSim's f32 step MG on a 16x8 plate over 4 steps;
- AffineDesignOperator.astype / .matvec on the 4x2 plate;
- gather_dofs, scatter_add, cell_matvec, make_matvec (with a space and
  with a raw dofmap), transpose_cellwise and make_jvp_matvec on an 8x8
  nonlinear Poisson problem, against the live JAX package.

The JAX results are pinned in tests/reference_digits/f32.npz by
`FEMO_PLATFORM=cpu python tools/f32_reference_digits.py tests` (the JAX
package with FEMO_SETUP_CACHE=0, FEMO_COMPILE_CACHE=0 and its other FEMO_*
solver flags unset, except FEMO_MG_F32=1 / FEMO_OP_STORAGE=f32 where a case
names them; its CG passes also from processes pinned to 1 and 4 cores).

Bars. Where f32 only preconditions an f64 solve (MG, band, AMG,
PlateSim) the solution is the f64 one: state and J 1e-8, dJ/dh 1e-6; CG
passes within the JAX runs' span widened by benchmarks.MG_PASS_SLACK (the
rounding rule of the MG phases), each PlateSim step within its first
entry of the JAX run's count. Where f32 changes the result (the f32
operator storage; an f32 AMG state) the port is held to the JAX package's
f32 result within twice that result's own f32 error, its distance from
the JAX package's f64 one (two f32 roundings of one computation, each as
accurate as the JAX one, lie no farther apart), and to its converged
flags."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from femo_alpha_tpu.assembly import assemble as RA
from femo_alpha_tpu.mesh import createUnitSquareMesh as ref_square
from femo_alpha_tpu.models import NonlinearPoissonModel as RefNLP

from femo_alpha_tpu_torch.assembly import assemble as A
from femo_alpha_tpu_torch.assembly.affine import AffineDesignOperator
from femo_alpha_tpu_torch.benchmarks import (
    MG_PASS_SLACK,
    LibraryBench,
    cg_passes_agree,
    gust_history,
)
from femo_alpha_tpu_torch.mesh import (
    createRectangleMesh,
    createUnitSquareMesh,
    createWingShellMesh,
)
from femo_alpha_tpu_torch.models import NonlinearPoissonModel
from femo_alpha_tpu_torch.models.dynamic_rm_shell import PlateSim
from femo_alpha_tpu_torch.models.dynamic_rm_shell.mg import build_platesim_mg
from femo_alpha_tpu_torch.models.rm_shell.mg import (
    ShellMGPrecond,
    build_shell_mg,
    shell_mg_precond_factory,
    strong_bc_dofs,
)
from femo_alpha_tpu_torch.models.rm_shell.pde import RMShellPDE
from femo_alpha_tpu_torch.solvers import band as B
from femo_alpha_tpu_torch.solvers.amg import AggregationAMG
from femo_alpha_tpu_torch.solvers.krylov import cg_solve
from femo_alpha_tpu_torch.solvers.linear import _sum_of_blocks

REF_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "reference_digits", "f32.npz")
F32 = torch.float32


@pytest.fixture(scope="module")
def ref():
    with np.load(REF_NPZ) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _plate(**env):
    """LibraryBench(64, 16) built with the FEMO_* flags `env` (read at
    model construction), and its first evaluate + compliance backward from
    zero."""
    with pytest.MonkeyPatch.context() as mp:
        for k in ("FEMO_MG_F32", "FEMO_OP_STORAGE"):
            mp.delenv(k, raising=False)
        for k, v in env.items():
            mp.setenv(k, v)
        b = LibraryBench(nx=64, ny=16, device="cpu")
    out = b.forward_adjoint(b.th0)
    info = b.pde.last_info
    return b, out, [info["forward"], info["adjoint"]]


@pytest.fixture(scope="module")
def mg_plate():
    return _plate(FEMO_MG_F32="1")


def _runs(ref, name):
    """The JAX runs' passes per solve: [[fwd runs], [adj runs]]."""
    runs = [ref[f"{name}_passes"], ref[f"{name}_passes_1"],
            ref[f"{name}_passes_4"]]
    return [[r[i] for r in runs] for i in range(2)]


# ------------------------------------------------------------- the MG
def test_mg_f32_hierarchy_matches_reference(mg_plate, ref):
    """FEMO_MG_F32=1 builds the f32 hierarchy (f32 forms and bases on the
    coarse level, an f32 V-cycle state) and the f64 solve lands on the JAX
    package's digits, in as many CG passes as its runs take."""
    b, out, infos = mg_plate
    pc = b.pde._pc
    assert isinstance(pc, ShellMGPrecond) and pc.dtype == F32
    assert len(pc.mg.levels) == 2
    assert pc.mg.levels[1]["affine_asm"]._aff.basis.dtype == F32
    J = float(out["J"])
    assert abs(J / float(ref["mg_J"]) - 1.0) <= 1e-8
    assert _rel(out["u"], ref["mg_u"]) <= 1e-8
    assert _rel(out["grad"], ref["mg_grad"]) <= 1e-6
    for info, runs in zip(infos, _runs(ref, "mg")):
        assert cg_passes_agree(info["passes"], runs, MG_PASS_SLACK), \
            (info["passes"], runs)


def test_shell_mg_precond_factory_f32():
    """The plain factory takes dtype=float32 (it raised before): it sets
    up the f32 hierarchy from the parameters at each linearization (every
    level assembled directly in f32: GeometricMG.setup(dtype=float32)) and
    its V-cycle takes and returns the vector's dtype. A 32x16 plate with
    coarsest_cells 64 (2 levels): the factory has no JAX digits here."""
    mesh = createRectangleMesh(32, 16, (0, 0), (10.0, 2.0), "quad", gdim=3)
    pde = RMShellPDE(mesh, element_wise_material=True, device="cpu")
    mg = build_shell_mg(pde, lambda x: x[:, 0] < 1e-12, coarsest_cells=64,
                        dtype=F32, device="cpu")
    assert len(mg.levels) == 2
    nel, nn = mesh.n_cells, mesh.n_nodes
    t = dict(dtype=torch.float64)
    params = {"thickness": torch.full((nel,), 0.2, **t),
              "E": torch.full((nel,), 4.32e8, **t),
              "nu": torch.zeros(nel, **t), "uhat": torch.zeros(3 * nn, **t),
              "F_solid": torch.zeros(3 * nn, **t)}
    M = shell_mg_precond_factory(mg, dtype=F32)(None, params)
    v = torch.as_tensor(np.random.default_rng(2).standard_normal(
        pde.W.n_dofs))
    y = M(v)
    assert y.dtype == torch.float64 and float(torch.dot(v, y)) > 0.0
    state = mg.setup(params, dtype=F32)
    assert all(a.dtype == F32 for a in state["Ae"])
    assert state["lmax"][0].dtype == F32 and state["coarse_inv"].dtype == F32
    assert torch.equal(y, mg.apply(state, v.to(F32)).double())


# -------------------------------------------------- the operator storage
def test_op_storage_f32_matches_reference(ref):
    """FEMO_OP_STORAGE=f32 rounds the fine operator's basis to f32 (K2's
    f32 build combines it) and the solve applies those entries in f64, as
    the JAX package does on the CPU: the result moves off the f64 one by
    the storage's own error (2.5e-5 in J here), and the port lands within
    twice that distance of the JAX package's f32-storage result, with its
    converged flags and CG passes."""
    b, out, infos = _plate(FEMO_OP_STORAGE="f32")
    emf = b.pde.element_matrices_fn
    assert emf.storage == "f32" and emf._aff.basis.dtype == F32
    J, J_ref, J64 = (float(out["J"]), float(ref["storage_J"]),
                     float(ref["f64_J"]))
    assert abs(J - J_ref) <= 2.0 * abs(J_ref - J64)
    assert _rel(out["u"], ref["storage_u"]) <= 2.0 * _rel(ref["storage_u"],
                                                          ref["f64_u"])
    assert [i["converged"] for i in infos] == list(ref["storage_converged"])
    for info, runs in zip(infos, _runs(ref, "storage")):
        assert cg_passes_agree(info["passes"], runs, MG_PASS_SLACK), \
            (info["passes"], runs)


# ----------------------------------------------------------- the band
@pytest.fixture(scope="module")
def wing_system():
    """The 8x36 penalty wing's assembled system (cell + facet blocks,
    unconstrained), as tools/f32_reference_digits.py builds it."""
    m = createWingShellMesh(n_chord=8, n_span=36, rib_stations=(18,))
    pde = RMShellPDE(m, element_wise_material=True, device="cpu")
    nel, n = m.n_cells, pde.W.n_dofs
    th = 0.02 * (1.0 + 0.2 * np.random.default_rng(4).uniform(size=nel))
    t = dict(dtype=torch.float64)
    p = {"thickness": torch.as_tensor(th), "E": torch.full((nel,), 7e10, **t),
         "nu": torch.full((nel,), 0.33, **t),
         "uhat": torch.zeros(3 * m.n_nodes, **t),
         "F_solid": torch.zeros(3 * m.n_nodes, **t)}
    ff = pde.make_penalty_facet_form(lambda x: np.abs(x[:, 1]) < 1e-9)
    u0 = torch.zeros(n, **t)
    ops = [A.element_matrices(pde.make_residual_form(), u0, p)
           .permute(1, 2, 0).contiguous(), ff.element_ops(u0, p)]
    mv = _sum_of_blocks(list(zip(ops, [pde.W, ff.block])),
                        torch.ones(n, **t))
    return pde, ff, ops, mv, n


def test_band_f32_precond_on_penalty_wing(wing_system, ref):
    """The reference's test_band_f32_precond_cg on the 8x36 wing: f32
    factor, no shift needed (as in the JAX run), CG converged in <= 40
    iterations to rel <= 2e-8, the state 1e-8 from the JAX run's."""
    pde, ff, ops, mv, n = wing_system
    band = B.BandCholPrecond(pde.W, [pde.W.dofmap, ff.block.dofmap],
                             dtype=F32)
    state = band.setup(ops)
    assert state["Ld"].dtype == F32 and state["s"].dtype == torch.float64
    assert state["shifted"] == (not bool(ref["band_unshifted_finite"]))
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(n))
    x, info = cg_solve(mv, b, M=lambda v: band.apply(state, v), tol=1e-8,
                       maxiter=60)
    assert info["converged"] and info["iters"] <= 40
    rel = float(torch.linalg.norm(mv(x) - b) / torch.linalg.norm(b))
    assert rel <= 2e-8
    assert _rel(x.numpy(), ref["band_x"]) <= 1e-8


def _spd_band(n, bw, w, m, neg=0.0):
    """A band matrix (half bandwidth bw) in block-band storage: SPD, or,
    when neg > 0, shifted down so that its least eigenvalue is -neg times
    its mean diagonal (about -neg once equilibrated)."""
    rng = np.random.default_rng(0)
    Q = np.zeros((n, n))
    for i in range(n):
        for j in range(max(0, i - bw // 2), i + 1):
            Q[i, j] = rng.standard_normal()
    M = Q @ Q.T + np.eye(n)
    if neg:
        lam0 = np.linalg.eigvalsh(M)[0]
        M = M - (lam0 + neg * np.mean(np.diag(M))) * np.eye(n)
    nb = -(-n // w)
    K = (m + 1) * w
    R = np.zeros((nb, w, K))
    Mp = np.eye(nb * w)
    Mp[:n, :n] = M
    for t in range(nb):
        for r in range(w):
            for c in range(K):
                j = (t - m) * w + c
                if 0 <= j <= t * w + r:
                    R[t, r, c] = Mp[t * w + r, j]
    return torch.as_tensor(R)


def test_band_f32_guard_shifts_once_then_raises():
    """The f32 guard: a factor that fails (cholesky_ex's info) is taken
    again once with the shift on the equilibrated diagonal; one that fails
    again raises; the f64 factor never shifts."""
    w, m = 8, 2
    st = B.band_factor(_spd_band(40, 10, w, m), w, m, F32)
    assert not st["shifted"] and st["Ld"].dtype == F32
    # one eigenvalue -1e-7 of the equilibrated matrix: the shift cures it
    st = B.band_factor(_spd_band(40, 10, w, m, neg=1e-7), w, m, F32)
    assert st["shifted"]
    assert bool(torch.isfinite(st["Ld"]).all() & torch.isfinite(
        st["Lc"]).all())
    # -1e-3 lies past the 1e-5 shift: the second factor fails too
    with pytest.raises(RuntimeError, match="shifted"):
        B.band_factor(_spd_band(40, 10, w, m, neg=1e-3), w, m, F32)
    with pytest.raises(RuntimeError, match="not positive definite"):
        B.band_factor(_spd_band(40, 10, w, m, neg=1e-7), w, m,
                      torch.float64)


# ------------------------------------------------------------- the AMG
def test_amg_f32_setup_applies_in_f64(ref):
    """AggregationAMG.setup(dtype=float32) on the 6x8 wing: the state in
    f32 (its lmax over the f32 kernel twins), each apply in the vector's
    dtype on that state, as the JAX package's (the root clamped by the
    free mask); the f32 state's apply lies within twice the JAX package's
    own f32 error (7.8e-4 here) of its f32 and f64 applies."""
    m = createWingShellMesh(n_chord=6, n_span=8, rib_stations=(4,))
    pde = RMShellPDE(m, element_wise_material=True, device="cpu")
    n, nel = pde.W.n_dofs, m.n_cells
    t = dict(dtype=torch.float64)
    p = {"thickness": torch.full((nel,), 0.01, **t),
         "E": torch.full((nel,), 7e10, **t),
         "nu": torch.full((nel,), 0.33, **t),
         "uhat": torch.zeros(3 * m.n_nodes, **t),
         "F_solid": torch.zeros(3 * m.n_nodes, **t)}
    Ae_T = A.element_matrices(pde.make_residual_form(), torch.zeros(n, **t),
                              p).permute(1, 2, 0).contiguous()
    free = torch.as_tensor(ref["amg6_free"])
    assert torch.equal(free[torch.as_tensor(strong_bc_dofs(
        pde, lambda x: np.abs(x[:, 1]) < 1e-9))], torch.zeros(
            int((free == 0).sum()), dtype=torch.float64))
    amg = AggregationAMG(pde.W)
    st = amg.setup(Ae_T, free_mask=free, dtype=F32)
    assert st["Ae"].dtype == F32 and st["lmax"].dtype == F32
    assert st["coarse_inv"].dtype == F32
    b = torch.as_tensor(ref["amg6_b"])
    y = amg.apply(st, b)
    assert y.dtype == torch.float64
    assert abs(float(st["lmax"]) / float(ref["amg6_lmax32"]) - 1.0) <= 1e-5
    err = _rel(ref["amg6_y32"], ref["amg6_y64"])  # 7.8e-4
    assert _rel(y.numpy(), ref["amg6_y64"]) <= 2.0 * err
    assert _rel(y.numpy(), ref["amg6_y32"]) <= 2.0 * err
    y64 = amg.apply(amg.setup(Ae_T, free_mask=free), b)
    assert _rel(y64.numpy(), ref["amg6_y64"]) <= 1e-10


# ------------------------------------------------------- the PlateSim
def test_platesim_f32_step_mg_matches_reference(ref):
    """build_platesim_mg(sim, dtype=float32) on a 16x8 plate (2 levels):
    the total strain energy and its thickness gradient on the JAX digits,
    each step solve's CG iterations within MG_PASS_SLACK[0] of the JAX
    run's."""
    mesh = createRectangleMesh(16, 8, (0, 0), (10.0, 2.0), "quad", gdim=3)
    s = PlateSim(mesh, E=4.32e8, nu=0.0, rho=100.0, dt=0.01, Nsteps=4,
                 element_wise_thickness=True, solver_method="mg",
                 mg_coarsest_cells=16, device="cpu")
    s.mg = build_platesim_mg(s, coarsest_cells=16, dtype=F32)
    assert s.mg.dtype == F32 and len(s.mg.levels) == 2
    th = torch.full((s.num_var,), 0.1, dtype=torch.float64,
                    requires_grad=True)
    wh = s.simulate(th, gust_history(mesh.n_nodes, 4, s.dt))
    e = s.strain_energy_history(wh, th).sum()
    e.backward()
    assert abs(float(e) / float(ref["sim_energy"]) - 1.0) <= 1e-8
    assert _rel(th.grad.numpy(), ref["sim_grad"]) <= 1e-6
    iters = [k for _, k in s.solve_log]
    assert len(iters) == len(ref["sim_iters"])
    assert all(abs(a - int(r)) <= MG_PASS_SLACK[0]
               for a, r in zip(iters, ref["sim_iters"])), \
        (iters, ref["sim_iters"].tolist())


# ------------------------------------------------- the affine operator
def test_affine_astype_and_matvec(ref):
    """AffineDesignOperator.matvec (K per-cell passes, no Ae) and its
    astype(float32) copy, on the 4x2 plate against the JAX package's:
    f64 1e-13; the f32 basis applied to an f64 vector (in f64, as the JAX
    package reads it) and to an f32 vector 1e-6."""
    mesh = createRectangleMesh(4, 2, (0, 0), (10.0, 2.0), "quad", gdim=3)
    pde = RMShellPDE(mesh, element_wise_material=True, device="cpu")
    nel, nn, n = mesh.n_cells, mesh.n_nodes, pde.W.n_dofs
    t = dict(dtype=torch.float64)
    others = {"E": torch.full((nel,), 4.32e8, **t),
              "nu": torch.full((nel,), 0.3, **t),
              "uhat": torch.zeros(3 * nn, **t),
              "F_solid": torch.zeros(3 * nn, **t)}
    aff = AffineDesignOperator(pde.make_residual_form(),
                               torch.zeros(n, **t),
                               lambda th: {**others, "thickness": th},
                               probe_scale=0.2)
    th = torch.as_tensor(ref["affine_theta"])
    x = torch.as_tensor(ref["affine_x"])
    assert _rel(aff.matvec(th, pde.W, x).numpy(), ref["affine_y64"]) <= 1e-13
    a32 = aff.astype(F32)
    assert a32.basis.dtype == F32 and aff.basis.dtype == torch.float64
    basis_ref = np.moveaxis(ref["affine_basis32"], 1, -1)  # lane-major
    assert (np.abs(a32.basis.numpy() - basis_ref).max()
            <= 1e-6 * np.abs(basis_ref).max())
    y32 = a32.matvec(th, pde.W, x)
    assert y32.dtype == torch.float64
    assert _rel(y32.numpy(), ref["affine_y32"]) <= 1e-6
    y32f = a32.matvec(th.float(), pde.W, x.float())
    assert y32f.dtype == F32
    assert _rel(y32f.numpy(), ref["affine_y32_f32"]) <= 1e-6


# --------------------------------------------- the cell-major operator API
@pytest.fixture(scope="module")
def poisson():
    """The 8x8 nonlinear Poisson problem of both packages at a seeded
    state: forms, spaces and element matrices."""
    rng = np.random.default_rng(5)
    model = NonlinearPoissonModel(createUnitSquareMesh(8, 8), device="cpu")
    rmodel = RefNLP(ref_square(8, 8))
    form = model.fea.states["u"].pde.form
    rform = rmodel.fea.states["u"].pde.form
    n, nc = model.V.n_dofs, model.mesh.n_cells
    p = {"kappa": 1.0 + rng.uniform(size=nc), "f": rng.uniform(size=n)}
    u = rng.standard_normal(n)
    pt = {k: torch.as_tensor(v) for k, v in p.items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    Ae = A.element_matrices(form, torch.as_tensor(u), pt)
    rAe = RA.element_matrices(rform, jnp.asarray(u), pj)
    return dict(form=form, rform=rform, V=model.V, rV=rmodel.V, n=n, u=u,
                pt=pt, pj=pj, Ae=Ae, rAe=rAe, x=rng.standard_normal(n))


def test_cell_major_matvec_matches_reference(poisson):
    P = poisson
    x, n = P["x"], P["n"]
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    dm = np.asarray(P["V"].dofmap)
    assert np.abs(A.transpose_cellwise(P["Ae"]).numpy()
                  - np.asarray(jnp.moveaxis(P["rAe"], 0, -1))).max() <= \
        1e-13 * float(np.abs(P["rAe"]).max())
    assert torch.equal(A.transpose_cellwise_inv(
        A.transpose_cellwise(P["Ae"])), P["Ae"])
    ref_sp = np.asarray(RA.make_matvec(P["rAe"], P["rV"])(xj))
    ref_dm = np.asarray(RA.make_matvec(P["rAe"], jnp.asarray(dm), n)(xj))
    assert _rel(A.make_matvec(P["Ae"], P["V"])(xt).numpy(), ref_sp) <= 1e-13
    assert _rel(A.make_matvec(P["Ae"], dm, n)(xt).numpy(), ref_dm) <= 1e-13
    xc = A.gather_dofs(xt, dm)
    assert np.array_equal(xc.numpy(), np.asarray(RA.gather_dofs(
        xj, jnp.asarray(dm))))
    yc = A.cell_matvec(P["Ae"], xc)
    ryc = RA.cell_matvec(P["rAe"], RA.gather_dofs(xj, jnp.asarray(dm)))
    assert _rel(yc.numpy(), ryc) <= 1e-13
    assert _rel(A.scatter_add(dm, yc, n).numpy(),
                RA.scatter_add(jnp.asarray(dm), ryc, n)) <= 1e-13


def test_make_jvp_matvec_matches_reference(poisson):
    """The linearized residual of the nonlinear Poisson form at u, by
    torch.func.linearize, against jax.linearize's, and against the
    assembled element matrices' operator."""
    P = poisson
    v = P["x"]

    def res(u):
        return A.assemble_residual(P["form"], u, P["pt"])

    def rres(u):
        return RA.assemble_residual(P["rform"], u, P["pj"])

    jv = A.make_jvp_matvec(res, torch.as_tensor(P["u"]))(torch.as_tensor(v))
    rjv = np.asarray(RA.make_jvp_matvec(rres, jnp.asarray(P["u"]))(
        jnp.asarray(v)))
    assert _rel(jv.numpy(), rjv) <= 1e-13
    assert _rel(A.make_matvec(P["Ae"], P["V"])(torch.as_tensor(v)).numpy(),
                rjv) <= 1e-13
