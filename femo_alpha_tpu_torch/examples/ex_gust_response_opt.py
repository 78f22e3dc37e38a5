"""Gust-response thickness optimization (1-cos gust load history) on a
24x4 plate wing stand-in (6 x 1 m, clamped at x = 0): minimize mass
subject to a total-strain-energy constraint over the gust (1.5 x the
baseline's), then the same objective through the online-output mode
(simulate_outputs: checkpointed segments, no stored history).

    python -m femo_alpha_tpu_torch.examples.ex_gust_response_opt [--maxiter 40] [--Nsteps 40] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh import StructuredQuadMesh
from ..models.dynamic_rm_shell import (
    PlateSim,
    StateOperation,
    TotalStrainEnergyOperation,
    VolumeOperation,
)
from ..opt import OptimizationProblem
from ._common import f64, numpy_of, one_minus_cos, parse_args, solve_recorded

E, nu, rho = 69e9, 0.33, 2700.0  # aluminum wing-skin-like
h0 = 0.005
span, chord = 6.0, 1.0
dt, NSTEPS = 0.005, 40  # the reference's time-step study point
MAXITER = 40
BASE_PRESSURE = 2000.0  # N/m^2


def build(Nsteps=NSTEPS, device=None):
    """The plate, its PlateSim with the gust history and h0 set,
    evaluate(dv) -> {total_strain_energy, mass} and the SLSQP problem;
    `baseline` holds the outputs at h0."""
    kw = f64(device)
    mesh = StructuredQuadMesh(24, 4, (0, 0), (span, chord), gdim=3)
    nn, nel = mesh.n_nodes, mesh.n_cells
    sim = PlateSim(mesh, E, nu, rho, dt, Nsteps, element_wise_thickness=True,
                   custom_bc_func=lambda x: x[:, 0] < 1e-12, quad_deg=4,
                   device=device)
    gust = one_minus_cos(Nsteps, dt, Nsteps * dt / 2)
    f_hist = np.zeros((Nsteps + 1, nn * 3))
    f_hist[:, 2::3] = BASE_PRESSURE * gust[:, None]
    sim.update_f_history(f_hist)
    sim.update_t(np.full(nel, h0))
    state_op = StateOperation(sim)
    tse_op = TotalStrainEnergyOperation(sim)
    vol_op = VolumeOperation(sim)

    def evaluate(dv):
        wh = state_op.evaluate(dv["thickness"])
        return {"total_strain_energy": tse_op.evaluate(wh, dv["thickness"]),
                "mass": rho * vol_op.evaluate(dv["thickness"])}

    with torch.no_grad():
        base = evaluate({"thickness": sim.t_array})
    E_total0, mass0 = (float(base["total_strain_energy"]),
                       float(base["mass"]))
    max_strain_energy = 1.5 * E_total0
    prob = OptimizationProblem(evaluate, device=device)
    prob.add_design_variable("thickness", h0 * np.ones(nel), lower=1e-3,
                             upper=0.05)
    prob.set_objective("mass", scaler=1.0 / mass0)
    prob.add_constraint("total_strain_energy", upper=max_strain_energy)
    return dict(mesh=mesh, model=sim, evaluate=evaluate, problem=prob,
                baseline={"total_strain_energy": E_total0, "mass": mass0},
                max_strain_energy=max_strain_energy, kw=kw)


def main(argv=None):
    args = parse_args(argv, __doc__, maxiter=MAXITER, Nsteps=NSTEPS)
    ex = build(args.Nsteps, args.device)
    sim, base = ex["model"], ex["baseline"]
    E0, mass0 = base["total_strain_energy"], base["mass"]
    print(f"baseline: total strain energy {E0:.6g}, mass {mass0:.4f} kg")
    dvs, res, record = solve_recorded(ex["problem"], args.maxiter, 1e-7)
    with torch.no_grad():
        out = ex["evaluate"](dvs)
    E_opt = float(out["total_strain_energy"])
    mse = ex["max_strain_energy"]
    print(f"optimized mass: {float(out['mass']):.4f} kg "
          f"(constraint E <= {mse:.6g}, achieved {E_opt:.6g})")
    # the long-horizon variant: the online-output mode computes the same
    # objective without materializing the (time_levels, fe_dofs) history
    with torch.no_grad():
        onl = sim.simulate_outputs(dvs["thickness"],
                                   torch.as_tensor(sim.f_history, **ex["kw"]))
    E_onl = float(onl["total_strain_energy"])
    print(f"online-mode check: total strain energy {E_onl:.6g} "
          f"(history path {E_opt:.6g})")
    return {"n_dofs": sim.fe_dofs, "solver_method": sim.solver_method,
            "total_strain_energy0": E0, "mass0": mass0, **record,
            "thickness": numpy_of(dvs["thickness"]),
            "mass": float(out["mass"]), "total_strain_energy": E_opt,
            "online_total_strain_energy": E_onl}


if __name__ == "__main__":
    main()
