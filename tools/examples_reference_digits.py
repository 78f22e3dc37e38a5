"""The JAX package's numbers on the repo's example studies (examples/), the
reference side of tests/test_torch_examples.py (`tests`) and of
chip_smoke.py's `examples` phase (`chip`):

    FEMO_PLATFORM=cpu FEMO_COMPILE_CACHE=0 FEMO_SETUP_CACHE=0 python tools/examples_reference_digits.py tests
    FEMO_PLATFORM=cpu FEMO_COMPILE_CACHE=0 FEMO_SETUP_CACHE=0 python tools/examples_reference_digits.py chip

Each part rebuilds every script's problem through the JAX package's API,
as the script builds it, at the cut that part names in CUTS (SLSQP
maxiter, Nsteps), and writes its numbers into
tests/reference_digits/examples.npz under "<part>.<script>.<key>" (the
other part's keys are kept), with the scipy version beside the SLSQP
histories (`scipy`: the trajectory depends on it). An SLSQP study keeps
the scaled objective and the design at each iterate (callback order) and
nit / nfev / njev; ex_gust_response_wing keeps the CG iterations of every
step solve, forward then adjoint, read from inside the JAX solver by a
debug callback. ex_million_dof_shell is held through the JAX package's
LibraryBench (the same plate and quadrature as the port's; the script's
ShellBench integrates with quad_deg 2 and is on the replace list).
ex_pav_wing_thickness_opt keeps only its mass at h0 here: its SLSQP
history is tools/opt_reference_digits.py's. ex_frequency_constrained_opt
and ex_aeroelastic_interface are in the `chip` part only: on the CPU,
tests/test_torch_modal.py and tests/test_torch_shape.py hold their
problems at their own digits.

`tests` takes ~16 min on 8 cores (most of it jit compiles), `chip` ~25
min, ~17 of them the c172 wing's 40-step forward and adjoint (~5,400
Jacobi-CG iterations per step solve, ~5 ms each in the JAX package on
the CPU).
"""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import scipy  # noqa: E402

import femo_alpha_tpu.models.dynamic_rm_shell.plate_sim as ref_plate_sim  # noqa: E402
from femo_alpha_tpu.mesh import (  # noqa: E402
    StructuredQuadMesh,
    createRectangleMesh,
    createWingShellMesh,
    readFEAMesh,
)
from femo_alpha_tpu.mesh.wing import RIB_TAG, SKIN_TAG  # noqa: E402
from femo_alpha_tpu.models import RMShellModel  # noqa: E402
from femo_alpha_tpu.models.dynamic_rm_shell import (  # noqa: E402
    PlateSim,
    StateOperation,
    TotalStrainEnergyOperation,
    VolumeOperation,
)
from opt_reference_digits import RecordingProblem  # noqa: E402

OUT = os.path.join(ROOT, "tests", "reference_digits", "examples.npz")
DATA = os.path.join(ROOT, "tests", "data")

# the cut of each script in each part (the scripts' own values elsewhere)
CUTS = {
    "tests": {
        "ex_gust_response_wing": dict(Nsteps=3, grad=False),
        "ex_lpc_gust_like_opt": dict(Nsteps=4, maxiter=1),
        "ex_tiltrotor_like_opt": dict(maxiter=1),
        "ex_lpc_static_multicase_opt": dict(maxiter=1),
        "ex_gust_response_opt": dict(Nsteps=4, maxiter=1),
        "ex_simple_dynamic_shell_opt": dict(Nsteps=4, maxiter=1),
        "ex_simple_shell": dict(maxiter=1),
        "ex_modal_analysis": dict(),
        "ex_plate_shape_opt": dict(maxiter=1),
        "ex_thickness_opt_cantilever_beam": dict(),
        "ex_million_dof_shell": dict(nx=16, ny=4),
        "ex_pav_wing_thickness_opt": dict(),
    },
    "chip": {
        "ex_gust_response_wing": dict(Nsteps=40, grad=True),
        # the second SLSQP iterate of the lpc study follows rounding
        # (tools/examples_rounding_probe.py): one iteration on the card
        "ex_lpc_gust_like_opt": dict(Nsteps=16, maxiter=1),
        "ex_tiltrotor_like_opt": dict(maxiter=2),
        "ex_lpc_static_multicase_opt": dict(maxiter=2),
        "ex_frequency_constrained_opt": dict(maxiter=2),
        "ex_aeroelastic_interface": dict(),
    },
}


def solve_recorded(prob, maxiter, ftol):
    xs = []
    dvs, res = prob.solve(maxiter=maxiter, ftol=ftol, report=False,
                          callback=lambda x: xs.append(np.array(x)))
    hist = [prob.seen[np.asarray(x, dtype=np.float64).tobytes()]
            for x in xs]
    return dvs, {"history": np.asarray(hist), "designs": np.asarray(xs),
                 "counts": np.asarray([res.nit, res.nfev, res.njev]),
                 "fun": np.asarray(res.fun)}


def one_minus_cos(Nsteps, dt, ramp):
    t_axis = np.arange(Nsteps + 1) * dt
    return 0.5 * (1 - np.cos(2 * np.pi * np.clip(t_axis / ramp, 0, 1)))


def bay_layout(mesh, span, n_span, rib_stations):
    nel = mesh.n_cells
    bay_edges = np.array([0.0] + [span * j / n_span for j in rib_stations]
                         + [span * 1.001])
    cell_y = np.asarray(mesh.coords)[np.asarray(mesh.conn)].mean(axis=1)[:, 1]
    cell_bay = np.searchsorted(bay_edges, cell_y, side="right") - 1
    n_bays = len(bay_edges) - 1
    is_rib = np.zeros(nel, dtype=bool)
    rib_cells = mesh.cell_tags.get(RIB_TAG)
    if rib_cells is not None:
        is_rib[np.asarray(rib_cells)] = True
    P = np.zeros((nel, n_bays + 1))
    for c in range(nel):
        P[c, n_bays if is_rib[c] else int(cell_bay[c])] = 1.0
    return P, cell_bay, is_rib, bay_edges


class _CGLog:
    """Records the iterations of every PlateSim step solve: cg_solve in
    the JAX plate_sim module wrapped so that its iteration count reaches
    the host through jax.debug.callback, in execution order."""

    def __init__(self):
        self.iters = []
        self._orig = ref_plate_sim.cg_solve

    def __enter__(self):
        orig, log = self._orig, self.iters

        def cg_logged(*a, **k):
            x, info = orig(*a, **k)
            jax.debug.callback(lambda n: log.append(int(n)), info["iters"])
            return x, info

        ref_plate_sim.cg_solve = cg_logged
        return self

    def __exit__(self, *exc):
        ref_plate_sim.cg_solve = self._orig


def gust_wing(Nsteps, grad):
    """examples/advanced_examples/gust_response_opt/ex_gust_response_wing.py"""
    E, nu, rho, h0, dt = 69e9, 0.33, 2700.0, 0.003, 0.005
    mesh = readFEAMesh(os.path.join(DATA, "c172_like_wing_648.msh"))
    nn = mesh.n_nodes
    with _CGLog() as log:
        sim = PlateSim(mesh, E, nu, rho, dt, Nsteps,
                       element_wise_thickness=True,
                       custom_bc_func=lambda x: x[:, 1] < 1e-9, quad_deg=4)
        gust = one_minus_cos(Nsteps, dt, Nsteps * dt / 2)
        f_hist = np.zeros((Nsteps + 1, nn * 3))
        for i, g in enumerate(gust):
            f = np.zeros((nn, 3))
            f[:, 2] = 800.0 * g
            f_hist[i] = f.reshape(-1)
        sim.update_f_history(f_hist)
        sim.update_t(np.full(sim.num_var, h0))
        state_op = StateOperation(sim)
        tse_op = TotalStrainEnergyOperation(sim)
        vol_op = VolumeOperation(sim)
        mass = rho * float(vol_op.evaluate(sim.t_array))

        def J(t):
            return jnp.reshape(tse_op.evaluate(state_op.evaluate(t), t), ())

        out = {"solver_method": np.asarray(sim.solver_method),
               "n_dofs": np.asarray(sim.fe_dofs), "mass": np.asarray(mass)}
        if grad:
            # the script's forward, then jax.grad's forward and adjoint:
            # one value_and_grad gives the same numbers in half the solves
            E_total, g = jax.value_and_grad(J)(sim.t_array)
            jax.effects_barrier()
            out["grad"] = np.asarray(g)
            out["grad_norm"] = np.asarray(float(jnp.linalg.norm(g)))
            out["cg_iters_forward"] = np.asarray(log.iters[:Nsteps])
            out["cg_iters_adjoint"] = np.asarray(log.iters[Nsteps:])
        else:
            wh = state_op.evaluate(sim.t_array)
            E_total = tse_op.evaluate(wh, sim.t_array)
            jax.effects_barrier()
            out["cg_iters_forward"] = np.asarray(log.iters)
        out["total_strain_energy"] = np.asarray(float(E_total))
    return out


def lpc_gust(Nsteps, maxiter):
    """examples/advanced_examples/lpc_gust_response_opt/ex_lpc_gust_like_opt.py"""
    from femo_alpha_tpu.models.rm_shell import buckling as bk

    E, nu, rho, dt = 69e9, 0.33, 2700.0, 0.005
    V_p, boom_mass, stress_cf, rho_sm, g = 400.0, 45.0, 1.5, 300.0, 9.81
    n_chord, n_span = 6, 10
    span, root_chord, taper, sweep = 10.0, 1.6, 0.5, 0.3
    rib_stations = (3, 7)
    mesh = createWingShellMesh(n_chord=n_chord, n_span=n_span, span=span,
                               root_chord=root_chord, taper=taper,
                               sweep=sweep, rib_stations=rib_stations,
                               shuffle_seed=11)
    nel, nn = mesh.n_cells, mesh.n_nodes
    sim = PlateSim(mesh, E, nu, rho, dt, Nsteps, element_wise_thickness=True,
                   custom_bc_func=lambda x: x[:, 1] < 1e-9,
                   add_self_weight=True, quad_deg=4)
    P, cell_bay, is_rib, bay_edges = bay_layout(mesh, span, n_span,
                                                rib_stations)
    n_bays = len(bay_edges) - 1
    P = jnp.asarray(P)
    masks = [jnp.asarray(((cell_bay == b) & ~is_rib).astype(np.float64))
             for b in range(n_bays)]

    def corner(y, le):
        t = y / span
        chord = root_chord * (1.0 - (1.0 - taper) * t)
        return np.array([sweep * span * t + (0.0 if le else chord), y, 0.0])

    bay_corners = []
    for b in range(n_bays):
        y0, y1 = bay_edges[b], min(bay_edges[b + 1], span)
        bay_corners.append(np.stack([corner(y0, True), corner(y0, False),
                                     corner(y1, True), corner(y1, False)]))
    gust = one_minus_cos(Nsteps, dt, Nsteps * dt)
    eta = np.clip(np.asarray(mesh.coords[:, 1]) / span, 0.0, 1.0)
    lift_shape = np.sqrt(1.0 - eta**2)
    boom_nodes = []
    for j in rib_stations:
        d = np.linalg.norm(np.asarray(mesh.coords)
                           - corner(span * j / n_span, True), axis=1)
        boom_nodes.append(int(np.argmin(d)))
    F_boom = np.zeros(nn * 3)
    for b in boom_nodes:
        F_boom[3 * b + 2] = -boom_mass * g
    to_field = sim.pde.make_force_to_pressure_solver()
    p_boom = np.asarray(to_field(jnp.asarray(F_boom)))
    f_hist = np.zeros((Nsteps + 1, nn * 3))
    for i, gv in enumerate(gust):
        f = np.zeros((nn, 3))
        f[:, 2] = V_p * gv * lift_shape
        f_hist[i] = f.reshape(-1) + p_boom
    sim.update_f_history(f_hist)
    state_op = StateOperation(sim)
    i_peak = int(np.argmax(gust))
    scale = {"0": 1.0}

    def smooth_max(x):
        z = rho_sm * scale["0"] * jnp.abs(x)
        return jax.nn.logsumexp(z) / (rho_sm * scale["0"])

    def ev(dv):
        th = P @ dv["h_bay"]
        wh = state_op.evaluate(th).reshape(sim.time_levels, sim.fe_dofs)
        uz = wh[:, : 3 * nn].reshape(sim.time_levels, nn, 3)[:, :, 2]
        out = type("Out", (), {})()
        out.mass = rho * sim.volume(th)
        out.max_disp = smooth_max(uz)
        vm = sim.von_Mises_stress(wh[i_peak], th)
        out.vm = vm
        vm_cell = vm.reshape(nel, -1).mean(1)
        margins = []
        for b in range(n_bays):
            m = masks[b]
            sig = stress_cf * jnp.vdot(vm_cell, m) / jnp.sum(m)
            margins.append(bk.bay_buckling_margins(
                sig, 0.3 * sig, E, nu, dv["h_bay"][b], bay_corners[b]))
        out.buckling_margin = jnp.stack(margins)
        out.min_margin = jnp.min(out.buckling_margin)
        return out

    h0 = 0.006
    dv0 = {"h_bay": h0 * np.ones(n_bays + 1)}
    base = ev({"h_bay": jnp.asarray(dv0["h_bay"])})
    scale["0"] = 1.0 / float(base.max_disp)
    base = ev({"h_bay": jnp.asarray(dv0["h_bay"])})
    mass0, d0 = float(base.mass), float(base.max_disp)
    out = {"n_dofs": np.asarray(sim.fe_dofs),
           "solver_method": np.asarray(sim.solver_method),
           "scale_0": np.asarray(scale["0"]), "mass0": np.asarray(mass0),
           "max_disp0": np.asarray(d0),
           "margins0": np.asarray(base.buckling_margin),
           "vm_peak_field0": np.asarray(base.vm)}
    prob = RecordingProblem(ev)
    prob.add_design_variable("h_bay", dv0["h_bay"], lower=0.0015, upper=0.02)
    prob.set_objective("max_disp", scaler=1.0 / d0)
    prob.add_constraint("mass", upper=mass0, scaler=1.0 / mass0)
    prob.add_constraint("buckling_margin", lower=0.0)
    dvs, rec = solve_recorded(prob, maxiter, 1e-8)
    fin = ev(dvs)
    out.update(rec, h_bay=np.asarray(dvs["h_bay"]),
               max_disp=np.asarray(float(fin.max_disp)),
               mass=np.asarray(float(fin.mass)),
               buckling_margin=np.asarray(fin.buckling_margin))
    return out


def _wing_bays(n_chord, n_span, rib_stations, tagged=False):
    mesh = createWingShellMesh(n_chord=n_chord, n_span=n_span,
                               rib_stations=rib_stations, shuffle_seed=3)
    tags = ({t: np.asarray(idx) for t, idx in mesh.cell_tags.items()}
            if tagged else None)
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 1] < 1e-9,
                         element_wise_material=True, mesh_tags=tags)
    span = float(np.max(mesh.coords[:, 1]))
    P = jnp.asarray(bay_layout(mesh, span, n_span, rib_stations)[0])
    return mesh, model, span, P


def tiltrotor(maxiter):
    """examples/advanced_examples/tiltrotor_opt/ex_tiltrotor_like_opt.py"""
    from femo_alpha_tpu.models.rm_shell.model import AggregatedStressModel

    mesh, model, span, P = _wing_bays(6, 12, (4, 8), tagged=True)
    nel, nn = mesh.n_cells, mesh.n_nodes
    n_dv = P.shape[1]
    eta = np.clip(np.asarray(mesh.coords[:, 1]) / span, 0.0, 1.0)
    pressure = np.zeros((nn, 3))
    pressure[:, 2] = 2500.0 * np.sqrt(1.0 - eta**2)
    pressure = jnp.asarray(pressure)
    base = dict(E=jnp.full(nel, 69e9), nu=jnp.full(nel, 0.33),
                density=jnp.full(nel, 2700.0))

    def ev(dv):
        th = P @ dv["h_bay"]
        out = model.evaluate(pressure, thickness=th, is_pressure=True,
                             **base)
        uz = out.disp_extracted[:, 2]
        out.max_disp = jnp.sum(jnp.abs(uz) ** 20.0) ** (1.0 / 20.0)
        return out

    h0 = 0.006
    dv0 = {"h_bay": h0 * np.ones(n_dv)}
    out0 = ev({"h_bay": jnp.asarray(dv0["h_bay"])})
    mass0, agg0, d0 = (float(out0.mass), float(out0.aggregated_stress),
                       float(out0.max_disp))
    prob = RecordingProblem(ev)
    prob.add_design_variable("h_bay", dv0["h_bay"], lower=0.002, upper=0.02)
    prob.set_objective("mass", scaler=1.0 / mass0)
    prob.add_constraint("aggregated_stress", upper=1.05 * agg0,
                        scaler=1.0 / agg0)
    prob.add_constraint("max_disp", upper=0.9 * d0, scaler=1.0 / d0)
    dvs, rec = solve_recorded(prob, maxiter, 1e-9)
    fin = ev(dvs)
    agg = AggregatedStressModel(model.m, model.rho)
    return dict(
        rec, n_dofs=np.asarray(model.shell_pde.W.n_dofs),
        mass0=np.asarray(mass0), aggregated_stress0=np.asarray(agg0),
        max_disp0=np.asarray(d0), h_bay=np.asarray(dvs["h_bay"]),
        mass=np.asarray(float(fin.mass)),
        aggregated_stress=np.asarray(float(fin.aggregated_stress)),
        max_disp=np.asarray(float(fin.max_disp)),
        aggregated_stress_skin=np.asarray(float(agg.evaluate(
            getattr(fin, f"pnorm_stress_{SKIN_TAG}")))),
        aggregated_stress_rib=np.asarray(float(agg.evaluate(
            getattr(fin, f"pnorm_stress_{RIB_TAG}")))))


def lpc_static(maxiter):
    """examples/advanced_examples/lpc_shell_opt/ex_lpc_static_multicase_opt.py"""
    MAX_STRESS, MAX_DISPLACEMENT = 350e6, 0.55
    MIN_THICKNESS, INITIAL_THICKNESS = 0.0003, 0.01
    SYSTEM_MASS, G = 3617.0, 9.81
    mesh, model, span, P = _wing_bays(6, 12, (4, 8))
    nel, nn = mesh.n_cells, mesh.n_nodes
    n_dv = P.shape[1]
    eta = np.clip(np.asarray(mesh.coords[:, 1]) / span, 0.0, 1.0)
    shape = np.sqrt(1.0 - eta**2)
    coords, conn = np.asarray(mesh.coords), np.asarray(mesh.conn)
    skin = np.asarray(mesh.cell_tags.get(1))
    planform = float(np.sum(np.linalg.norm(np.cross(
        coords[conn[skin, 1]] - coords[conn[skin, 0]],
        coords[conn[skin, 3]] - coords[conn[skin, 0]]), axis=1)))
    p1g = SYSTEM_MASS / 2.0 * G / max(planform, 1.0)

    def maneuver_pressure(n_factor):
        p = np.zeros((nn, 3))
        p[:, 2] = n_factor * p1g * shape
        return jnp.asarray(p)

    cases = {"plus_3g": maneuver_pressure(3.0),
             "minus_1g": maneuver_pressure(-1.0)}
    base = dict(E=jnp.full(nel, 69e9), nu=jnp.full(nel, 0.33),
                density=jnp.full(nel, 2700.0))
    tip_nodes = np.where(np.asarray(mesh.coords[:, 1]) > span * (1 - 1e-9))[0]

    def ev(dv):
        th = P @ dv["h_bay"]
        out_all = None
        for name, pressure in cases.items():
            out = model.evaluate(pressure, thickness=th, is_pressure=True,
                                 **base)
            uz_tip = out.disp_extracted[tip_nodes, 2]
            tip = jnp.sum(jnp.abs(uz_tip) ** 20.0) ** (1.0 / 20.0)
            if out_all is None:
                out_all = out
            setattr(out_all, f"{name}_stress", out.aggregated_stress)
            setattr(out_all, f"{name}_tip_disp", tip)
        return out_all

    dv0 = {"h_bay": INITIAL_THICKNESS * np.ones(n_dv)}
    out0 = ev({"h_bay": jnp.asarray(dv0["h_bay"])})
    mass0 = float(out0.mass)
    disp_limit = min(MAX_DISPLACEMENT,
                     0.9 * float(getattr(out0, "plus_3g_tip_disp")))
    prob = RecordingProblem(ev)
    prob.add_design_variable("h_bay", dv0["h_bay"], lower=MIN_THICKNESS,
                             upper=0.02)
    prob.set_objective("mass", scaler=1.0 / mass0)
    for name in cases:
        prob.add_constraint(f"{name}_stress", upper=MAX_STRESS, scaler=1e-8)
        prob.add_constraint(f"{name}_tip_disp", upper=disp_limit,
                            scaler=1.0 / disp_limit)
    dvs, rec = solve_recorded(prob, maxiter, 1e-9)
    fin = ev(dvs)
    out = dict(rec, n_dofs=np.asarray(model.shell_pde.W.n_dofs),
               mass0=np.asarray(mass0), disp_limit=np.asarray(disp_limit),
               h_bay=np.asarray(dvs["h_bay"]),
               mass=np.asarray(float(fin.mass)))
    for name in cases:
        for k in ("stress", "tip_disp"):
            out[f"{name}_{k}0"] = np.asarray(float(getattr(out0,
                                                           f"{name}_{k}")))
            out[f"{name}_{k}"] = np.asarray(float(getattr(fin,
                                                          f"{name}_{k}")))
    return out


def gust_plate(Nsteps, maxiter):
    """examples/advanced_examples/gust_response_opt/ex_gust_response_opt.py"""
    E, nu, rho, h0, dt = 69e9, 0.33, 2700.0, 0.005, 0.005
    mesh = StructuredQuadMesh(24, 4, (0, 0), (6.0, 1.0), gdim=3)
    nn, nel = mesh.n_nodes, mesh.n_cells
    sim = PlateSim(mesh, E, nu, rho, dt, Nsteps, element_wise_thickness=True,
                   custom_bc_func=lambda x: x[:, 0] < 1e-12, quad_deg=4)
    gust = one_minus_cos(Nsteps, dt, Nsteps * dt / 2)
    f_hist = np.zeros((Nsteps + 1, nn * 3))
    for i, g in enumerate(gust):
        f = np.zeros((nn, 3))
        f[:, 2] = 2000.0 * g
        f_hist[i] = f.reshape(-1)
    sim.update_f_history(f_hist)
    sim.update_t(np.full(nel, h0))
    state_op = StateOperation(sim)
    tse_op = TotalStrainEnergyOperation(sim)
    vol_op = VolumeOperation(sim)
    wh = state_op.evaluate(sim.t_array)
    E0 = float(tse_op.evaluate(wh, sim.t_array))
    mass0 = rho * float(vol_op.evaluate(sim.t_array))

    def ev(dv):
        wh = state_op.evaluate(dv["thickness"])
        return {"total_strain_energy": tse_op.evaluate(wh, dv["thickness"]),
                "mass": rho * vol_op.evaluate(dv["thickness"])}

    prob = RecordingProblem(ev)
    prob.add_design_variable("thickness", h0 * np.ones(nel), lower=1e-3,
                             upper=0.05)
    prob.set_objective("mass", scaler=1.0 / mass0)
    prob.add_constraint("total_strain_energy", upper=1.5 * E0)
    dvs, rec = solve_recorded(prob, maxiter, 1e-7)
    fin = ev(dvs)
    onl = sim.simulate_outputs(jnp.asarray(dvs["thickness"]),
                               jnp.asarray(sim.f_history))
    return dict(rec, n_dofs=np.asarray(sim.fe_dofs),
                solver_method=np.asarray(sim.solver_method),
                total_strain_energy0=np.asarray(E0),
                mass0=np.asarray(mass0),
                thickness=np.asarray(dvs["thickness"]),
                mass=np.asarray(float(fin["mass"])),
                total_strain_energy=np.asarray(
                    float(fin["total_strain_energy"])),
                online_total_strain_energy=np.asarray(
                    float(onl["total_strain_energy"])))


def simple_dynamic(Nsteps, maxiter):
    """examples/advanced_examples/simple_dynamic_shell_opt/
    ex_simple_dynamic_shell_opt.py, with run_check_derivatives on"""
    E, nu, rho, h, dt = 4.32e8, 0.0, 10.0, 0.2, 0.01
    mesh = StructuredQuadMesh(10, 2, (0, 0), (10, 2), gdim=3)
    sim = PlateSim(mesh, E, nu, rho, dt, Nsteps, element_wise_thickness=True,
                   quad_deg=4)
    nn, nel = mesh.n_nodes, mesh.n_cells
    f = np.zeros((nn, 3))
    f[:, 2] = 2.0
    sim.update_f_history(np.tile(f.reshape(1, -1), (Nsteps + 1, 1)))
    sim.update_t(np.full(nel, h))
    state_op = StateOperation(sim)
    tse_op = TotalStrainEnergyOperation(sim)
    vol_op = VolumeOperation(sim)
    w_hist = state_op.evaluate(sim.t_array)
    E0 = float(tse_op.evaluate(w_hist, sim.t_array))
    V0 = float(vol_op.evaluate(sim.t_array))

    def obj(p):
        wh = state_op.evaluate(p["thickness"])
        return jnp.reshape(tse_op.evaluate(wh, p["thickness"]), ())

    g = jax.grad(obj)({"thickness": sim.t_array})["thickness"]

    def ev(dv):
        wh = state_op.evaluate(dv["thickness"])
        return {"total_strain_energy": tse_op.evaluate(wh, dv["thickness"]),
                "volume": vol_op.evaluate(dv["thickness"])}

    prob = RecordingProblem(ev)
    prob.add_design_variable("thickness", h * np.ones(nel), lower=1e-2,
                             upper=10.0)
    prob.add_constraint("volume", equals=h * 2 * 10)
    prob.set_objective("total_strain_energy")
    dvs, rec = solve_recorded(prob, maxiter, 1e-8)
    return dict(rec, n_dofs=np.asarray(sim.fe_dofs),
                solver_method=np.asarray(sim.solver_method),
                total_strain_energy0=np.asarray(E0), volume0=np.asarray(V0),
                grad=np.asarray(g), thickness=np.asarray(dvs["thickness"]))


def simple_shell(maxiter):
    """examples/advanced_examples/simple_shell_opt/ex_simple_shell.py,
    with run_check_derivatives on"""
    E_val, nu_val, h_val, rho_val = 4.32e8, 0.0, 0.2, 1.0
    width, length = 2.0, 10.0
    mesh = StructuredQuadMesh(20, 4, (0, 0), (length, width), gdim=3)
    nel, nn = mesh.n_cells, mesh.n_nodes
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 0] < 3e-16,
                         element_wise_material=True, record=False)
    pressure = np.zeros((nn, 3))
    pressure[:, 2] = 10.0 * h_val
    base = dict(E=jnp.full(nel, E_val), nu=jnp.full(nel, nu_val),
                density=jnp.full(nel, rho_val))
    out = model.evaluate(jnp.asarray(pressure),
                         thickness=jnp.full(nel, h_val), is_pressure=True,
                         **base)

    def agg(th):
        o = model.evaluate(jnp.asarray(pressure), thickness=th,
                           is_pressure=True, **base)
        return jnp.reshape(o.aggregated_stress, ())

    g = jax.grad(agg)(jnp.full(nel, h_val))

    def ev(dv):
        return model.evaluate(jnp.asarray(pressure),
                              thickness=dv["thickness"], is_pressure=True,
                              **base)

    prob = RecordingProblem(ev)
    prob.add_design_variable("thickness", h_val * np.ones(nel), lower=1e-2,
                             upper=10.0)
    prob.add_constraint("mass", equals=rho_val * h_val * width * length)
    prob.set_objective("compliance")
    dvs, rec = solve_recorded(prob, maxiter, 1e-9)
    return dict(rec, n_dofs=np.asarray(model.shell_pde.W.n_dofs),
                tip=np.asarray(float(np.asarray(out.disp_solid).max())),
                mass0=np.asarray(float(out.mass)),
                aggregated_stress0=np.asarray(float(out.aggregated_stress)),
                compliance0=np.asarray(float(out.compliance)),
                grad=np.asarray(g), thickness=np.asarray(dvs["thickness"]))


def modal():
    """examples/advanced_examples/modal_analysis/ex_modal_analysis.py"""
    E_val, nu_val, rho_val, h_val = 7.0e10, 0.3, 2700.0, 0.01
    mesh = StructuredQuadMesh(20, 10, (0, 0), (2.0, 1.0), gdim=3)
    nel = mesh.n_cells
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 0] < 3e-16,
                         element_wise_material=True, PENALTY_BC=False)
    th = jnp.full(nel, h_val)
    E, nu, dens = (jnp.full(nel, v) for v in (E_val, nu_val, rho_val))
    out = model.evaluate_modal(th, E, nu, dens, n_modes=6)
    g = jax.grad(lambda t: out.eig_fn(t, E, nu, dens)[0])(th)
    return {"n_dofs": np.asarray(model.shell_pde.W.n_dofs),
            "eigenvalues": np.asarray(out.eigenvalues),
            "frequencies": np.asarray(out.frequencies), "grad": np.asarray(g)}


def plate_shape(maxiter):
    """examples/advanced_examples/shape_opt/ex_plate_shape_opt.py, with
    run_check_derivatives off"""
    mesh = createRectangleMesh(32, 8, (0, 0), (10.0, 2.0), "quad", gdim=3)
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 0] < 1e-12,
                         element_wise_material=True, PENALTY_BC=False)
    nel, nn = model.nel, model.nn
    E, nu, rho, th = (jnp.full(nel, v) for v in (4.32e8, 0.0, 100.0, 0.2))
    force = jnp.zeros(3 * nn).at[2::3].set(2.0)

    def evaluate(dvs):
        node_disp = jnp.zeros((nn, 3)).at[:, 1].set(dvs["dy"])
        return model.evaluate(force, th, E, nu, rho, node_disp=node_disp,
                              is_pressure=True)

    J0 = float(evaluate({"dy": jnp.zeros(nn)}).compliance)
    root = np.asarray(mesh.coords[:, 0]) < 1e-12
    prob = RecordingProblem(evaluate)
    prob.add_design_variable("dy", np.zeros(nn),
                             lower=np.where(root, 0.0, -0.2),
                             upper=np.where(root, 0.0, 0.2))
    prob.set_objective("compliance", scaler=1.0 / J0)
    dvs, rec = solve_recorded(prob, maxiter, 1e-12)
    J1 = float(evaluate({"dy": jnp.asarray(dvs["dy"])}).compliance)
    return dict(rec, n_dofs=np.asarray(model.shell_pde.W.n_dofs),
                J0=np.asarray(J0), compliance=np.asarray(J1),
                dy=np.asarray(dvs["dy"]))


def beam():
    """examples/basic_examples/beam_thickness_opt/
    ex_thickness_opt_cantilever_beam.py: the forward evaluation and the
    compliance's gradient at h = 0.1. Its SLSQP path is not kept: the
    first line searches reach thicknesses where the stiffness's condition
    number passes 1e15, and the JAX package's own runs part there (jit
    and eager, or two jitted runs: 3.4e7 against 8.2e6 at the first
    iterate); the study is held to the OpenMDAO optimum instead."""
    from femo_alpha_tpu.models import EulerBernoulliBeamModel

    nel = 50
    b = EulerBernoulliBeamModel(nel=nel, L=1.0, E=1.0, width=0.1,
                                tip_load=-1.0)
    out = b.evaluate(0.1 * np.ones(nel))
    g = jax.grad(lambda t: jnp.reshape(b.evaluate(t).compliance, ()))(
        jnp.full(nel, 0.1))
    return dict(compliance0=np.asarray(float(out.compliance)),
                volume0=np.asarray(float(out.volume)), grad=np.asarray(g))


def million(nx, ny):
    """examples/advanced_examples/large_scale/ex_million_dof_shell.py at
    nx x ny, through the JAX package's LibraryBench"""
    from femo_alpha_tpu.benchmarks import LibraryBench

    bench = LibraryBench(nx=nx, ny=ny)
    out = bench.forward_adjoint(bench.th0)
    return {"n_dofs": np.asarray(bench.n_dofs),
            "J": np.asarray(float(out["J"])),
            "grad": np.asarray(out["grad"]),
            "grad_norm": np.asarray(float(jnp.linalg.norm(out["grad"]))),
            "tip": np.asarray(float(jnp.max(jnp.abs(out["u"]))))}


def frequency_constrained(maxiter):
    """examples/advanced_examples/modal_analysis/
    ex_frequency_constrained_opt.py"""
    from femo_alpha_tpu.assembly.assemble import assemble_scalar

    h0 = 0.01
    mesh = StructuredQuadMesh(12, 6, (0, 0), (2.0, 1.0), gdim=3)
    nel = mesh.n_cells
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 0] < 3e-16,
                         element_wise_material=True, PENALTY_BC=False)
    E, nu, dens = (jnp.full(nel, v) for v in (7.0e10, 0.3, 2700.0))
    mass_form = model.shell_pde.mass_form()
    uhat0 = jnp.zeros(model.shell_pde.VU.n_dofs)
    lam0 = float(model.modal_eigenvalues(jnp.full(nel, h0), E, nu, dens,
                                         n_modes=1)[0])
    f0 = np.sqrt(lam0) / (2 * np.pi)
    target_lam = (2 * np.pi * (1.2 * f0)) ** 2

    def ev(dv):
        th = dv["thickness"]
        lam1 = model.modal_eigenvalues(th, E, nu, dens, n_modes=1)[0]
        mass = assemble_scalar(mass_form, th, {"density": dens,
                                               "uhat": uhat0})
        return {"lam1": lam1, "mass": mass}

    mass0 = float(ev({"thickness": jnp.full(nel, h0)})["mass"])
    prob = RecordingProblem(ev, jit=False)
    prob.add_design_variable("thickness", h0 * np.ones(nel),
                             lower=0.5 * h0, upper=3 * h0)
    prob.set_objective("mass", scaler=1.0 / mass0)
    prob.add_constraint("lam1", lower=target_lam, scaler=1.0 / target_lam)
    dvs, rec = solve_recorded(prob, maxiter, 1e-8)
    fin = ev(dvs)
    return dict(rec, lam0=np.asarray(lam0), mass0=np.asarray(mass0),
                thickness=np.asarray(dvs["thickness"]),
                mass=np.asarray(float(fin["mass"])),
                f1=np.asarray(float(np.sqrt(float(fin["lam1"]))
                                    / (2 * np.pi))))


def aeroelastic():
    """examples/advanced_examples/pav_shell_opt/ex_aeroelastic_interface.py"""
    span = 3.0
    mesh = StructuredQuadMesh(24, 4, (0, 0), (span, 1.0), gdim=3)
    nn, nel = mesh.n_nodes, mesh.n_cells
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 0] < 1e-12,
                         element_wise_material=True, record=False)
    y = mesh.coords[:, 0] / span
    pressure = np.zeros((nn, 3))
    pressure[:, 2] = 100.0 * np.sqrt(np.clip(1 - y**2, 0, 1))
    base = dict(E=jnp.full(nel, 69e9), nu=jnp.full(nel, 0.33),
                density=jnp.full(nel, 2700.0))

    def agg(dvs):
        eta = jnp.asarray(mesh.coords[:, 0] / span)
        nd = jnp.stack([dvs["stretch"] * span * eta, jnp.zeros(nn),
                        jnp.zeros(nn)], axis=1)
        out = model.evaluate(jnp.asarray(pressure),
                             thickness=dvs["thickness"], node_disp=nd,
                             is_pressure=True, **base)
        return jnp.reshape(out.aggregated_stress, ())

    dvs = {"thickness": jnp.full(nel, 0.02), "stretch": jnp.asarray(0.1)}
    val, g = jax.value_and_grad(agg)(dvs)
    return {"aggregated_stress": np.asarray(float(val)),
            "grad_stretch": np.asarray(float(g["stretch"])),
            "grad_thickness": np.asarray(g["thickness"])}


def pav():
    """examples/advanced_examples/pav_shell_opt/ex_pav_wing_thickness_opt.py:
    the mass at h0, the objective's scale (no solve)"""
    from femo_alpha_tpu.assembly.assemble import assemble_scalar

    mesh = readFEAMesh(os.path.join(DATA, "pav_like_wing_2388.msh"))
    nel = mesh.n_cells
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 1] < 1e-9,
                         element_wise_material=True, record=False,
                         mesh_tags={t: np.asarray(c)
                                    for t, c in mesh.cell_tags.items()})
    pde = model.shell_pde
    mass0 = float(assemble_scalar(pde.mass_form(), jnp.full(nel, 0.005),
                                  {"density": jnp.full(nel, 2780.0),
                                   "uhat": jnp.zeros(pde.VU.n_dofs)}))
    return {"n_dofs": np.asarray(pde.W.n_dofs), "mass0": np.asarray(mass0)}


RUNNERS = {
    "ex_gust_response_wing": gust_wing,
    "ex_lpc_gust_like_opt": lpc_gust,
    "ex_tiltrotor_like_opt": tiltrotor,
    "ex_lpc_static_multicase_opt": lpc_static,
    "ex_gust_response_opt": gust_plate,
    "ex_simple_dynamic_shell_opt": simple_dynamic,
    "ex_simple_shell": simple_shell,
    "ex_modal_analysis": modal,
    "ex_plate_shape_opt": plate_shape,
    "ex_thickness_opt_cantilever_beam": beam,
    "ex_million_dof_shell": million,
    "ex_pav_wing_thickness_opt": pav,
    "ex_frequency_constrained_opt": frequency_constrained,
    "ex_aeroelastic_interface": aeroelastic,
}


def main():
    parts = sys.argv[1:2] or ["tests"]
    only = sys.argv[2:]
    if parts[0] not in CUTS:
        raise SystemExit(f"usage: {sys.argv[0]} tests|chip [script ...]")
    part = parts[0]
    digits = {}
    for name, cut in CUTS[part].items():
        if only and name not in only:
            continue
        t0 = time.perf_counter()
        res = RUNNERS[name](**cut)
        for k, v in res.items():
            digits[f"{part}.{name}.{k}"] = np.asarray(v)
        print(f"{part}.{name} {cut}: {time.perf_counter() - t0:.1f} s",
              flush=True)
        for k, v in res.items():
            v = np.asarray(v)
            print(f"  {k} = {v.tolist() if v.size <= 8 else v.shape}")
    # the keys of the other part (and of scripts not run now) are kept
    kept = {}
    if os.path.exists(OUT):
        with np.load(OUT) as z:
            kept = {k: z[k] for k in z.files}
    kept.update(digits, scipy=np.asarray(scipy.__version__))
    np.savez_compressed(OUT, **kept)
    print(f"scipy {scipy.__version__}; wrote {os.path.relpath(OUT, ROOT)}")


if __name__ == "__main__":
    main()
