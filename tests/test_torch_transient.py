"""The transient RM shell of the port (PlateSim: implicit midpoint,
dense / Jacobi-PCG / MG-PCG step solves, the time-reversed adjoint through
autograd, checkpointed online outputs) on the CPU, against the JAX
package's results and against the port's own dense path.

Inputs are made with numpy from a seed; f64 throughout. The JAX package's
results at these inputs are pinned in tests/reference_digits/
transient_10x2.npz by `tools/transient_reference_digits.py tests` (the
JAX package on the CPU with its FEMO_* solver flags unset: FEMO_MG_F32,
FEMO_LANE_MAJOR, FEMO_HOSTLOOP, FEMO_CG_DF, FEMO_OP_STORAGE). Tolerances:
1e-12 relative for forms, bases and vjp_theta (the same arithmetic in
another order); 1e-10 for the displacement history and 1e-8 for gradients
(both packages take the dense f64 Cholesky path on the 10x2 fixture of
tests/test_dynamic_shell.py); 1e-8 of the displacement scale between the
port's iterative (tol 1e-11) and dense paths."""

import os

import numpy as np
import pytest
import torch

from femo_alpha_tpu_torch.adjoint import check_totals
from femo_alpha_tpu_torch.assembly.assemble import element_matrices
from femo_alpha_tpu_torch.mesh import StructuredQuadMesh, createRectangleMesh
from femo_alpha_tpu_torch.models.dynamic_rm_shell import (
    PlateSim,
    StateOperation,
    TotalStrainEnergyOperation,
    VolumeOperation,
)
from femo_alpha_tpu_torch.models.rm_shell.pde import RMShellPDE
from femo_alpha_tpu_torch.spaces.pointeval import point_eval_rows

E_VAL, NU, RHO, DT, N = 4.32e8, 0.0, 10.0, 0.01, 20
X_TIP = (10.0, 1.0, 0.0)
REF_NPZ = os.path.join(os.path.dirname(__file__), "reference_digits",
                       "transient_10x2.npz")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _inputs(nel, nn, steps=N, seed=0):
    """Seeded thickness around 0.2 and a z-load around 2 per node that
    varies in time and space."""
    rng = np.random.default_rng(seed)
    th = 0.2 * (1.0 + 0.1 * rng.uniform(-1.0, 1.0, nel))
    fh = np.zeros((steps + 1, 3 * nn))
    fh[:, 2::3] = 2.0 + 0.5 * rng.standard_normal((steps + 1, nn))
    return th, fh


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's PlateSim on the 10x2 fixture (dense path), pinned
    by tools/transient_reference_digits.py, beside the seeded inputs it
    was given: the thickness and load history, a load-history direction
    d_fh and two state-sized vectors u, lam."""
    mesh = createRectangleMesh(10, 2, (0, 0), (10, 2), "quad", gdim=3)
    th_np, fh_np = _inputs(mesh.n_cells, mesh.n_nodes)
    d_fh = np.random.default_rng(1).standard_normal(fh_np.shape)
    with np.load(REF_NPZ) as z:
        ref = {k: z[k] for k in z.files}
    rng = np.random.default_rng(2)
    u, lam = (rng.standard_normal(ref["wh"].shape[1]) for _ in range(2))
    return dict(
        th=th_np, fh=fh_np, d_fh=d_fh, u=u, lam=lam,
        wh=ref["wh"], g_th=ref["g_th"], dd_fh=float(ref["dd_fh"]),
        se=ref["se"], tips=ref["tips"], pn=ref["pn"], Ke=ref["Ke"],
        Me=ref["Me"], Mp=ref["Mp"], load=ref["load"], sw=ref["sw"],
        bases={"K": ref["basis_K"], "M": ref["basis_M"]},
        vjps={"K": ref["vjp_K"], "M": ref["vjp_M"]},
        tse_l2=float(ref["tse_l2"]), h1_cells=ref["h1_cells"],
        rows=[(int(ref["rows_cell"]), ref["rows_dofs"], ref["rows_w"])])


def _port_sim(**kw):
    mesh = createRectangleMesh(10, 2, (0, 0), (10, 2), "quad", gdim=3)
    sim = PlateSim(mesh, E_VAL, NU, RHO, dt=DT, Nsteps=N,
                   element_wise_thickness=True, quad_deg=4, device="cpu",
                   **kw)
    sim.set_up_tip_dofs(np.asarray(X_TIP))
    return sim


@pytest.fixture(scope="module")
def port(reference):
    sim = _port_sim()
    th = _t(reference["th"]).requires_grad_(True)
    wh = sim.simulate(th, reference["fh"])
    se = sim.strain_energy_history(wh, th)
    se.sum().backward()
    fh = _t(reference["fh"]).requires_grad_(True)
    sim.strain_energy_history(sim.simulate(_t(reference["th"]), fh),
                              _t(reference["th"])).sum().backward()
    return dict(sim=sim, wh=wh.detach(), se=se.detach(), g_th=th.grad,
                dd_fh=float(torch.sum(fh.grad * _t(reference["d_fh"]))))


def test_forms_match_reference(reference, port):
    """Inertia (scalar and field density, and with the J(uhat) pullback at
    uhat = 0), the self weight and the load: element matrices and vectors
    to 1e-12."""
    sim = port["sim"]
    pde, th = sim.pde, _t(reference["th"])
    zero = torch.zeros(sim.fe_dofs, dtype=torch.float64)
    Ke = element_matrices(sim.K_form, zero, sim._k_params(th))
    Me = element_matrices(sim.M_form, zero, sim._m_params(th))
    Mp = element_matrices(pde.inertia_form(rho_is_param=True), zero,
                          {"thickness": th,
                           "density": torch.full((sim.num_var,), 7.0,
                                                 dtype=torch.float64)})
    assert _rel(Ke, reference["Ke"]) <= 1e-12
    assert _rel(Me, reference["Me"]) <= 1e-12
    assert _rel(Mp, reference["Mp"]) <= 1e-12
    assert _rel(sim.assemble_load(reference["fh"][3]),
                reference["load"]) <= 1e-12
    assert _rel(sim.self_weight_vector(th), reference["sw"]) <= 1e-12
    # the J(uhat) pullback (the modal path) is the identity at uhat = 0;
    # tests/test_torch_modal.py holds it against the reference at uhat != 0
    Mu = element_matrices(pde.inertia_form(with_uhat=True), zero,
                          {"thickness": th,
                           "density": torch.full((sim.num_var,), 7.0,
                                                 dtype=torch.float64),
                           "uhat": torch.zeros(pde.VU.n_dofs,
                                               dtype=torch.float64)})
    assert _rel(Mu, reference["Mp"]) <= 1e-12
    # the H1 regularization: zero for this cell-constant thickness, and
    # the reference's on a nodal thickness of the same plate (1e-12)
    h1 = pde.regularization_kernel("H1")
    x = torch.as_tensor(np.asarray(pde.mesh.coords)[pde.mesh.conn[0]])
    assert float(h1(None, x, {"thickness": th[:1]})) == 0.0
    npde = RMShellPDE(pde.mesh, element_wise_material=False, inplane_deg=4,
                      device="cpu")
    th_n = 0.1 + 0.05 * np.random.default_rng(5).random(npde.mesh.n_nodes)
    conn, xs = np.asarray(npde.mesh.conn), np.asarray(npde.mesh.coords)
    for c in range(npde.mesh.n_cells):
        v = npde.regularization_kernel("H1")(
            None, torch.as_tensor(xs[conn[c]]),
            {"thickness": torch.as_tensor(th_n[conn[c]])})
        v_r = reference["h1_cells"][c]
        assert abs(float(v) / float(v_r) - 1.0) <= 1e-12


def test_affine_bases_and_vjp_theta_match_reference(reference, port):
    """The K (1, 3), M (1,) and step-operator A bases, and vjp_theta on
    seeded vectors, to 1e-12; A = (2/dt^2) M + K/2 basis by basis."""
    sim = port["sim"]
    th = _t(reference["th"])
    BK, BM, BA = sim._bases(th)
    ref_B = reference["bases"]
    assert _rel(BK, ref_B["K"]) <= 1e-12
    assert _rel(BM, ref_B["M"]) <= 1e-12
    ref_A = np.stack([2.0 / DT ** 2 * ref_B["M"][0] + 0.5 * ref_B["K"][0],
                      0.5 * ref_B["K"][1]])
    assert _rel(BA, ref_A) <= 1e-12
    u, lam = _t(reference["u"]), _t(reference["lam"])
    for name, asm in (("K", sim._K_asm), ("M", sim._M_asm)):
        got = asm.vjp_theta(th, u, lam, sim.W)
        assert _rel(got, reference["vjps"][name]) <= 1e-12, name


def test_point_eval_rows_identical(reference, port):
    ((c, dofs, w),) = point_eval_rows(port["sim"].pde.V_disp,
                                      [np.asarray(X_TIP)])
    ((c_r, dofs_r, w_r),) = reference["rows"]
    assert c == c_r
    np.testing.assert_array_equal(dofs, dofs_r)
    np.testing.assert_array_equal(w, w_r)


def test_history_and_gradients_match_reference(reference, port):
    """The dense path: w history and tip history to 1e-10, the energy
    history (quadratic in w) to 1e-9, the thickness gradient and one
    seeded f_history direction to 1e-8."""
    assert port["sim"].solver_method == "dense"
    assert _rel(port["wh"], reference["wh"]) <= 1e-10
    tips = torch.stack([port["sim"].tip_disp(w) for w in port["wh"]])
    assert _rel(tips, reference["tips"]) <= 1e-10
    assert _rel(port["se"], reference["se"]) <= 1e-9
    assert _rel(port["g_th"], reference["g_th"]) <= 1e-8
    assert abs(port["dd_fh"] / reference["dd_fh"] - 1.0) <= 1e-8


def test_simulate_outputs_matches_history_path(reference, port):
    """Checkpointed online outputs against the port's history path (values
    1e-9, w_final 1e-12, gradient 1e-8) and the p-norm history against the
    JAX package's (2e-9)."""
    sim = port["sim"]
    th = _t(reference["th"]).requires_grad_(True)
    out = sim.simulate_outputs(th, reference["fh"], segment_len=5,
                               with_residuals=True, stress_pnorm=(1e-6, 20))
    out["total_strain_energy"].backward()
    se, wh = port["se"], port["wh"]
    assert _rel(out["energy_history"].detach(), se[1:]) <= 1e-9
    total = float(out["total_strain_energy"].detach())
    assert abs(total / float(se.sum()) - 1) <= 1e-9
    assert float((out["w_final"].detach() - wh[-1]).abs().max()) <= \
        1e-12 * float(wh.abs().max())
    tips = torch.stack([sim.tip_disp(w) for w in wh[1:]])
    assert _rel(out["tip_history"].detach(), tips) <= 1e-10
    assert float(out["res_history"].max()) < 1e-9
    # sigma^20: the packages' 1e-10 displacement agreement, 20-fold
    assert _rel(out["pnorm_history"].detach(), reference["pn"]) <= 20e-10
    assert _rel(th.grad, port["g_th"]) <= 1e-8
    # the default segment: the divisor of N_t nearest sqrt(N_t)
    with torch.no_grad():
        e_d = sim.simulate_outputs(_t(reference["th"]), reference["fh"])
    assert abs(float(e_d["total_strain_energy"]) / total - 1) <= 1e-12


def _plate(nx, ny, structured=True):
    return createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad", gdim=3,
                               structured=structured)


@pytest.mark.parametrize("case", ["mg", "cg"])
def test_iterative_paths_match_dense(case):
    """MG-PCG on 16x8 (two levels, coarsest 32 cells) and Jacobi-PCG on
    6x3 against the port's dense path: trajectory to 1e-8 of its scale,
    the gradient of sum(w^2) at rtol 1e-6."""
    if case == "mg":
        mesh, kw = StructuredQuadMesh(16, 8, (0, 0), (10.0, 2.0), gdim=3), \
            dict(dt=0.005, Nsteps=6, mg_coarsest_cells=32)
    else:
        mesh, kw = _plate(6, 3), dict(dt=0.01, Nsteps=4)
    base = dict(E=E_VAL, nu=NU, rho=RHO, element_wise_thickness=True,
                device="cpu", **kw)
    sim_d = PlateSim(mesh, solver_method="dense", **base)
    sim_i = PlateSim(mesh, solver_method=case, **base)
    if case == "mg":
        assert sim_i.mg is not None and len(sim_i.mg.levels) == 2
    th_np, _ = _inputs(mesh.n_cells, mesh.n_nodes, kw["Nsteps"])
    fh = np.zeros((kw["Nsteps"] + 1, sim_d.W_f.n_dofs))
    fh[:, 2::3] = 1000.0
    res = {}
    for name, sim in (("dense", sim_d), (case, sim_i)):
        th = _t(th_np).requires_grad_(True)
        wh = sim.simulate(th, fh)
        (wh ** 2).sum().backward()
        res[name] = (wh.detach(), th.grad)
    scale = float(res["dense"][0].abs().max())
    assert float((res[case][0] - res["dense"][0]).abs().max()) < 1e-8 * scale
    np.testing.assert_allclose(res[case][1].numpy(), res["dense"][1].numpy(),
                               rtol=1e-6)
    iters = [it for ph, it in sim_i.solve_log if ph == "forward"]
    assert len(iters) == kw["Nsteps"] and max(iters) > 0


def test_unstructured_mesh_falls_back_cleanly():
    """6x3 has no coarser MG level: the 'mg' request falls back to a
    working solver, and a capped inner_iters warns in
    solve_dynamic_problem."""
    kw = dict(dt=0.01, Nsteps=3, element_wise_thickness=True, device="cpu")
    s = PlateSim(_plate(6, 3), E_VAL, NU, RHO, solver_method="mg", **kw)
    assert s.mg is None and s.solver_method == "dense"
    th = torch.full((s.num_var,), 0.2, dtype=torch.float64)
    fh = np.zeros((4, s.W_f.n_dofs))
    fh[:, 2::3] = 10.0
    assert torch.isfinite(s.simulate(th, fh)).all()
    s = PlateSim(_plate(6, 3, structured=False), E_VAL, NU, RHO,
                 solver_method="cg", inner_iters=1, **kw)
    assert s.mg is None
    s.update_f_history(fh)
    with pytest.warns(UserWarning, match="relative residual"):
        s.solve_dynamic_problem()


def test_residual_operations_and_check_totals(reference, port):
    """SVK_residual vanishes at the solution; the three operations; the
    transient adjoint against central differences (thickness and force
    history)."""
    sim = port["sim"]
    th = _t(reference["th"])
    fh = _t(reference["fh"])
    wh = port["wh"]
    r = sim.SVK_residual()(wh[1], wh[0], torch.zeros(sim.fe_dofs), th,
                           fh[1])
    free = sim.free_mask == 1.0
    F1 = sim.assemble_load(fh[1])
    assert float(r[free].abs().max()) <= 1e-9 * float(F1.abs().max())

    state = StateOperation(sim).evaluate(th, fh)
    assert _rel(state.reshape(sim.time_levels, -1), wh) <= 1e-12
    tse = TotalStrainEnergyOperation(sim, regularization="L2")
    assert abs(float(tse.evaluate(state, th)) / reference["tse_l2"] - 1) \
        <= 1e-10
    vol = float(VolumeOperation(sim).evaluate(th))
    assert abs(vol - float(th.mean()) * 20.0) <= 1e-12 * vol

    op, plain = StateOperation(sim), TotalStrainEnergyOperation(sim)
    check_totals(lambda p: plain.evaluate(op.evaluate(p["thickness"]),
                                          p["thickness"]),
                 {"thickness": th}, eps=1e-5, directions=2, rtol=1e-4,
                 verbose=False)
    check_totals(lambda f: plain.evaluate(op.evaluate(th, f), th), fh,
                 eps=1e-5, directions=1, rtol=1e-4, verbose=False)


def test_history_matches_independent_stepper():
    """The bar of tests/test_golden_fields.py: one transient history
    (8x4, 4 steps, seeded thickness, a load growing in time) against the
    independent numpy/scipy implicit-midpoint stepper of the same
    recurrence (tests/independent_shell.py) to 1e-8."""
    from independent_shell import implicit_midpoint_history

    nx, ny, L = 8, 4, 2.0
    mesh = createRectangleMesh(nx, ny, (0, 0), (L, 1.0), "quad", gdim=3)
    nn, nel = mesh.n_nodes, mesh.n_cells
    thickness = 0.02 + 0.01 * np.random.default_rng(11).random(nel)
    E, nu, rho, dt, nsteps = 7.0e10, 0.3, 2700.0, 0.002, 4
    f_hist = np.zeros((nsteps + 1, nn, 3))
    for i in range(nsteps + 1):
        f_hist[i, :, 2] = 500.0 * i / nsteps * (
            1.0 + np.asarray(mesh.coords[:, 0]) / L)
    sim = PlateSim(mesh, E, nu, rho, dt, nsteps, element_wise_thickness=True,
                   custom_bc_func=lambda x: x[:, 0] < 1e-12, quad_deg=4,
                   device="cpu")
    wh = sim.simulate(_t(thickness), f_hist.reshape(nsteps + 1, -1))
    u_lib = wh[:, : 3 * nn].reshape(nsteps + 1, nn, 3).numpy()
    u_ind = implicit_midpoint_history(
        np.asarray(mesh.coords), np.asarray(mesh.conn), thickness,
        np.full(nel, E), np.full(nel, nu), rho, dt, f_hist,
        bc_func=lambda xy: xy[:, 0] < 1e-12)
    assert _rel(u_lib, u_ind) <= 1e-8
    assert np.max(np.abs(u_ind[-1])) > 1e-7  # the plate actually moves
