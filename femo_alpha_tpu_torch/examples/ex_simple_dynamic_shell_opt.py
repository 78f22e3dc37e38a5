"""Transient shell thickness optimization of a step-loaded 10 x 2 plate
(10x2 mesh, clamped at x = 0 by PlateSim's default): minimize the total
strain energy over the time history subject to a fixed volume; the
transient adjoint is autograd through the time stepper.
run_check_derivatives checks that gradient against central differences
(off by default, as in the reference's script).

    python -m femo_alpha_tpu_torch.examples.ex_simple_dynamic_shell_opt [--maxiter 50] [--Nsteps 20] [--run_check_derivatives 1] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..adjoint import check_totals
from ..mesh import StructuredQuadMesh
from ..models.dynamic_rm_shell import (
    PlateSim,
    StateOperation,
    TotalStrainEnergyOperation,
    VolumeOperation,
)
from ..opt import OptimizationProblem
from ._common import numpy_of, parse_args, solve_recorded

E, nu, rho, h = 4.32e8, 0.0, 10.0, 0.2
dt, NSTEPS = 0.01, 20
MAXITER = 50
RUN_CHECK_DERIVATIVES = 0


def build(Nsteps=NSTEPS, device=None):
    """The plate, its PlateSim under a uniform step load, evaluate(dv) ->
    {total_strain_energy, volume}, the energy functional J(params) of the
    derivative check, and the SLSQP problem."""
    mesh = StructuredQuadMesh(10, 2, (0, 0), (10, 2), gdim=3)
    sim = PlateSim(mesh, E, nu, rho, dt, Nsteps, element_wise_thickness=True,
                   quad_deg=4, device=device)
    nn, nel = mesh.n_nodes, mesh.n_cells
    f = np.zeros((nn, 3))
    f[:, 2] = 2.0
    sim.update_f_history(np.tile(f.reshape(1, -1), (Nsteps + 1, 1)))
    sim.update_t(np.full(nel, h))
    state_op = StateOperation(sim)
    tse_op = TotalStrainEnergyOperation(sim)
    vol_op = VolumeOperation(sim)

    def evaluate(dv):
        wh = state_op.evaluate(dv["thickness"])
        return {"total_strain_energy": tse_op.evaluate(wh, dv["thickness"]),
                "volume": vol_op.evaluate(dv["thickness"])}

    def objective(p):
        return evaluate(p)["total_strain_energy"]

    prob = OptimizationProblem(evaluate, device=device)
    prob.add_design_variable("thickness", h * np.ones(nel), lower=1e-2,
                             upper=10.0)
    prob.add_constraint("volume", equals=h * 2 * 10)
    prob.set_objective("total_strain_energy")
    return dict(mesh=mesh, model=sim, evaluate=evaluate, objective=objective,
                problem=prob)


def main(argv=None):
    args = parse_args(argv, __doc__, maxiter=MAXITER, Nsteps=NSTEPS,
                      run_check_derivatives=RUN_CHECK_DERIVATIVES)
    ex = build(args.Nsteps, args.device)
    sim = ex["model"]
    t = sim.t_array.clone().requires_grad_(True)
    out = ex["evaluate"]({"thickness": t})
    E0 = float(out["total_strain_energy"].detach())
    V0 = float(out["volume"].detach())
    print("total strain energy @ uniform:", E0)
    print("volume:", V0)
    (g,) = torch.autograd.grad(out["total_strain_energy"], t)
    result = {"n_dofs": sim.fe_dofs, "solver_method": sim.solver_method,
              "total_strain_energy0": E0, "volume0": V0, "grad": numpy_of(g)}
    if args.run_check_derivatives:
        result["check_totals_max_rel"] = check_totals(
            ex["objective"], {"thickness": sim.t_array}, eps=1e-5)
    dvs, res, record = solve_recorded(ex["problem"], args.maxiter, 1e-8)
    print("optimized total strain energy:", res.fun, " nit:", res.nit)
    result.update(record, thickness=numpy_of(dvs["thickness"]))
    return result


if __name__ == "__main__":
    main()
