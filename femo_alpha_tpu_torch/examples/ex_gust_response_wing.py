"""Gust response of an aircraft wing shell read from a gmsh .msh file:
PlateSim on the c172-scale generated wing tests/data/c172_like_wing_648.msh
(648 quads, 9,831 mixed dofs), clamped at the root section, under a 1-cos
vertical gust pressure over the first half of the horizon; total strain
energy, skin mass and the thickness gradient of the energy through the
whole transient (the time-reversed adjoint sweep).

At 9,831 dofs PlateSim's step solver is Jacobi-preconditioned CG over the
fused constrained operator, on a step operator combined by the affine
kernel once per design.

    python -m femo_alpha_tpu_torch.examples.ex_gust_response_wing [--Nsteps 40] [--device cpu]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..mesh import readFEAMesh
from ..models.dynamic_rm_shell import (
    PlateSim,
    StateOperation,
    TotalStrainEnergyOperation,
    VolumeOperation,
)
from ._common import data_path, numpy_of, one_minus_cos, parse_args

E, nu, rho = 69e9, 0.33, 2700.0  # aluminum (gust example material class)
h0 = 0.003
dt, NSTEPS = 0.005, 40  # the reference's time-step study point
BASE_PRESSURE = 800.0   # N/m^2
MESH = data_path("c172_like_wing_648.msh")


def build(Nsteps=NSTEPS, device=None):
    """The wing, its PlateSim with the gust history and h0 set, and
    evaluate(t) -> {total_strain_energy, mass} (no SLSQP problem)."""
    mesh = readFEAMesh(MESH)
    nn = mesh.n_nodes
    # clamp the root section (y = 0 plane)
    sim = PlateSim(mesh, E, nu, rho, dt, Nsteps, element_wise_thickness=True,
                   custom_bc_func=lambda x: x[:, 1] < 1e-9, quad_deg=4,
                   device=device)
    gust = one_minus_cos(Nsteps, dt, Nsteps * dt / 2)
    f_hist = np.zeros((Nsteps + 1, nn * 3))
    f_hist[:, 2::3] = BASE_PRESSURE * gust[:, None]
    sim.update_f_history(f_hist)
    sim.update_t(np.full(sim.num_var, h0))
    state_op = StateOperation(sim)
    tse_op = TotalStrainEnergyOperation(sim)
    vol_op = VolumeOperation(sim)

    def evaluate(t):
        wh = state_op.evaluate(t)
        return {"total_strain_energy": tse_op.evaluate(wh, t),
                "mass": rho * vol_op.evaluate(t)}

    return dict(mesh=mesh, model=sim, evaluate=evaluate, problem=None)


def main(argv=None):
    args = parse_args(argv, __doc__, Nsteps=NSTEPS)
    ex = build(args.Nsteps, args.device)
    mesh, sim = ex["mesh"], ex["model"]
    print(f"wing: {mesh.n_cells} cells, {mesh.n_nodes} nodes "
          f"(from {os.path.basename(MESH)})")
    print(f"mixed dofs: {sim.fe_dofs}, step solver: {sim.solver_method}")
    t = sim.t_array.clone().requires_grad_(True)
    out = ex["evaluate"](t)
    E_total = float(out["total_strain_energy"].detach())
    mass = float(out["mass"].detach())
    print(f"total strain energy {E_total:.8g}, wing skin mass {mass:.4f} kg")
    # adjoint: dE_total/d(thickness) through the whole transient
    (g,) = torch.autograd.grad(out["total_strain_energy"], t)
    g_norm = float(torch.linalg.norm(g))
    finite = bool(torch.isfinite(g).all())
    print(f"|dE/dh| = {g_norm:.6g} (finite: {finite})")
    return {"total_strain_energy": E_total, "mass": mass,
            "grad_norm": g_norm, "grad": numpy_of(g),
            "n_dofs": sim.fe_dofs, "solver_method": sim.solver_method,
            "cg_iters": [k for _, k in sim.solve_log],
            "cg_phases": [p for p, _ in sim.solve_log]}


if __name__ == "__main__":
    main()
