"""Transient gust-response optimization of a rib-stiffened wing with
bay-wise thickness variables, a smooth-max displacement objective, a mass
constraint and per-bay panel-buckling margin constraints (the shell side
of the reference's lift-plus-cruise gust study):

- bay-wise thickness design variables between rib stations, split into
  skin and rib groups;
- a 1-cos gust force history through the implicit-midpoint transient,
  with self-weight, and boom weights as point forces at the rib-station
  leading-edge nodes, turned into an equivalent force field by the
  force-to-pressure mass-matrix solve;
- minimize the smooth maximum of |u_z| over the whole history
  (logsumexp, rho = 300, scaled by the baseline's) subject to the
  baseline mass;
- per-bay buckling margins at the gust peak from the bay-mean von Mises
  stress (DG1 projection) times stress_cf = 1.5, through the handbook
  formulas of models/rm_shell/buckling.py.

Everything is one autograd chain: thickness -> transient -> smooth-max
displacement / peak von Mises -> margins, so SLSQP gets exact adjoint
gradients through the whole time history.

    python -m femo_alpha_tpu_torch.examples.ex_lpc_gust_like_opt [--maxiter 30] [--Nsteps 16] [--n_chord 6] [--n_span 10] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh import createWingShellMesh
from ..mesh.wing import RIB_TAG
from ..models.dynamic_rm_shell import PlateSim, StateOperation
from ..models.rm_shell import buckling as bk
from ..opt import OptimizationProblem
from ._common import (
    bay_layout,
    f64,
    numpy_of,
    one_minus_cos,
    parse_args,
    solve_recorded,
)

E, nu, rho = 69e9, 0.33, 2700.0          # aluminum
dt, NSTEPS = 0.005, 16                   # reference dt; short horizon
V_p_pressure = 400.0                     # gust peak pressure, N/m^2
boom_mass = 45.0                         # kg per boom
stress_cf = 1.5                          # softmax->peak stress correction
rho_sm = 300.0                           # the reference's softmax rho
g = 9.81
MAXITER = 30
N_CHORD, N_SPAN = 6, 10                  # scale freely on device
span, root_chord, taper, sweep = 10.0, 1.6, 0.5, 0.3
rib_stations = (3, 7)
h0 = 0.006


def planform_corner(y, le):
    """The generator's planform at span station y: leading (le) or
    trailing edge point."""
    t = y / span
    chord = root_chord * (1.0 - (1.0 - taper) * t)
    x = sweep * span * t + (0.0 if le else chord)
    return np.array([x, y, 0.0])


def build(Nsteps=NSTEPS, n_chord=N_CHORD, n_span=N_SPAN, device=None):
    """The wing, its PlateSim with the gust + boom history, evaluate(dv)
    and the SLSQP problem (its smooth maximum scaled by the baseline's,
    as the script does before it solves); `baseline` holds the outputs at
    h0 with that scale."""
    kw = f64(device)
    mesh = createWingShellMesh(n_chord=n_chord, n_span=n_span, span=span,
                               root_chord=root_chord, taper=taper,
                               sweep=sweep, rib_stations=rib_stations,
                               shuffle_seed=11)
    nel, nn = mesh.n_cells, mesh.n_nodes
    sim = PlateSim(mesh, E, nu, rho, dt, Nsteps, element_wise_thickness=True,
                   custom_bc_func=lambda x: x[:, 1] < 1e-9,
                   add_self_weight=True, quad_deg=4, device=device)
    P, cell_bay, is_rib, bay_edges = bay_layout(mesh, span, n_span,
                                                rib_stations, RIB_TAG)
    n_bays = len(bay_edges) - 1
    P = torch.as_tensor(P, **kw)
    bay_cell_masks = [torch.as_tensor(((cell_bay == b) & ~is_rib)
                                      .astype(np.float64), **kw)
                      for b in range(n_bays)]
    # bay rectangles for the buckling formulas: between rib stations,
    # panel width = local chord, length = bay span (planform corners)
    bay_corners = []
    for b in range(n_bays):
        y0, y1 = bay_edges[b], min(bay_edges[b + 1], span)
        bay_corners.append(np.stack([planform_corner(y0, True),
                                     planform_corner(y0, False),
                                     planform_corner(y1, True),
                                     planform_corner(y1, False)]))

    gust = one_minus_cos(Nsteps, dt, Nsteps * dt)
    eta = np.clip(np.asarray(mesh.coords[:, 1]) / span, 0.0, 1.0)
    lift_shape = np.sqrt(1.0 - eta**2)   # elliptic-ish spanwise loading
    # boom point weights at the rib-station LE nodes -> an equivalent
    # force field by the mass-matrix solve
    boom_nodes = []
    for j in rib_stations:
        y_st = span * j / n_span
        d = np.linalg.norm(np.asarray(mesh.coords)
                           - planform_corner(y_st, True), axis=1)
        boom_nodes.append(int(np.argmin(d)))
    F_boom = np.zeros(nn * 3)
    for b in boom_nodes:
        F_boom[3 * b + 2] = -boom_mass * g
    to_field = sim.pde.make_force_to_pressure_solver()
    with torch.no_grad():
        p_boom = numpy_of(to_field(torch.as_tensor(F_boom, **kw)))
    f_hist = np.zeros((Nsteps + 1, nn * 3))
    f_hist[:, 2::3] = V_p_pressure * gust[:, None] * lift_shape[None, :]
    f_hist += p_boom[None, :]
    sim.update_f_history(f_hist)

    state_op = StateOperation(sim)
    i_peak = int(np.argmax(gust))
    scale = {"0": 1.0}  # the baseline's 1 / max_disp, set below

    def smooth_max(x):
        # csdl.maximum(|scale x|, rho=300) / scale: a logsumexp maximum
        z = rho_sm * scale["0"] * torch.abs(x)
        return torch.logsumexp(z.reshape(-1), 0) / (rho_sm * scale["0"])

    def evaluate(dv):
        th = P @ dv["h_bay"]
        wh = state_op.evaluate(th).reshape(sim.time_levels, sim.fe_dofs)
        uz = wh[:, : 3 * nn].reshape(sim.time_levels, nn, 3)[:, :, 2]
        out = {"mass": rho * sim.volume(th), "max_disp": smooth_max(uz)}
        # per-bay margins at the gust peak: von Mises (DG1, cellwise rows)
        # -> bay mean -> times stress_cf -> handbook margin
        vm = sim.von_Mises_stress(wh[i_peak], th)
        vm_cell = vm.reshape(nel, -1).mean(1)
        margins = []
        for b in range(n_bays):
            m = bay_cell_masks[b]
            sig = stress_cf * torch.dot(vm_cell, m) / torch.sum(m)
            margins.append(bk.bay_buckling_margins(
                sig, 0.3 * sig, E, nu, dv["h_bay"][b], bay_corners[b]))
        out["buckling_margin"] = torch.stack(margins)
        out["min_margin"] = torch.min(out["buckling_margin"])
        out["vm_peak"] = vm
        return out

    h_start = torch.full((n_bays + 1,), h0, **kw)
    with torch.no_grad():
        scale["0"] = 1.0 / float(evaluate({"h_bay": h_start})["max_disp"])
        base = evaluate({"h_bay": h_start})   # rescaled softmax
    mass0, d0 = float(base["mass"]), float(base["max_disp"])
    prob = OptimizationProblem(evaluate, device=device)
    prob.add_design_variable("h_bay", h0 * np.ones(n_bays + 1),
                             lower=0.0015, upper=0.02)
    prob.set_objective("max_disp", scaler=1.0 / d0)    # minimize_max_disp
    prob.add_constraint("mass", upper=mass0, scaler=1.0 / mass0)
    prob.add_constraint("buckling_margin", lower=0.0)
    return dict(mesh=mesh, model=sim, evaluate=evaluate, problem=prob,
                baseline=base, scale_0=scale["0"], i_peak=i_peak,
                h_start=h_start)


def main(argv=None):
    args = parse_args(argv, __doc__, maxiter=MAXITER, Nsteps=NSTEPS,
                      n_chord=N_CHORD, n_span=N_SPAN)
    ex = build(args.Nsteps, args.n_chord, args.n_span, args.device)
    mesh, sim, base = ex["mesh"], ex["model"], ex["baseline"]
    print(f"wing: {mesh.n_cells} cells, {mesh.n_nodes} nodes, "
          f"{sim.fe_dofs} mixed dofs, step solver: {sim.solver_method}")
    mass0, d0 = float(base["mass"]), float(base["max_disp"])
    margins0 = numpy_of(base["buckling_margin"])
    print(f"baseline: mass {mass0:.3f} kg, smooth-max disp {d0:.5f} m, "
          f"bay margins {np.round(margins0, 3)}")
    dvs, res, record = solve_recorded(ex["problem"], args.maxiter, 1e-8)
    with torch.no_grad():
        out = ex["evaluate"](dvs)
    h = numpy_of(dvs["h_bay"])
    print(f"optimized: smooth-max disp {float(out['max_disp']):.5f} m "
          f"(baseline {d0:.5f}), mass {float(out['mass']):.3f} <= "
          f"{mass0:.3f} kg, min buckling margin "
          f"{float(out['min_margin']):.4f} >= 0")
    print("bay thicknesses [skin bays..., ribs]:", np.round(h, 5))
    return {"n_dofs": sim.fe_dofs, "solver_method": sim.solver_method,
            "scale_0": ex["scale_0"], "mass0": mass0, "max_disp0": d0,
            "margins0": margins0,
            "vm_peak_field0": numpy_of(base["vm_peak"]),
            **record, "h_bay": h, "max_disp": float(out["max_disp"]),
            "mass": float(out["mass"]),
            "buckling_margin": numpy_of(out["buckling_margin"])}


if __name__ == "__main__":
    main()
