"""Shell thickness optimization of a cantilever plate (10 x 2, 20x4 mesh,
clamped at x = 0, uniform pressure): the forward deflection beside the
Euler-Bernoulli closed form, the aggregated stress's thickness gradient
checked against central differences (run_check_derivatives, off by
default as in the reference's script), and minimum compliance at fixed
mass by SLSQP.

    python -m femo_alpha_tpu_torch.examples.ex_simple_shell [--maxiter 200] [--run_check_derivatives 1] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..adjoint import check_totals
from ..mesh import StructuredQuadMesh
from ..models import RMShellModel
from ..opt import OptimizationProblem
from ._common import f64, numpy_of, parse_args, solve_recorded

E_val, nu_val, h_val, rho_val = 4.32e8, 0.0, 0.2, 1.0
width, length = 2.0, 10.0
f_d = 10.0 * h_val
MAXITER = 200
RUN_CHECK_DERIVATIVES = 0


def build(device=None):
    """The plate, its RMShellModel, evaluate(dv), the aggregated-stress
    functional of the derivative check and the SLSQP problem."""
    kw = f64(device)
    mesh = StructuredQuadMesh(20, 4, (0, 0), (length, width), gdim=3)
    nel, nn = mesh.n_cells, mesh.n_nodes
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 0] < 3e-16,
                         element_wise_material=True, record=False,
                         device=device)
    pressure = torch.zeros((nn, 3), **kw)
    pressure[:, 2] = f_d
    base = dict(E=torch.full((nel,), E_val, **kw),
                nu=torch.full((nel,), nu_val, **kw),
                density=torch.full((nel,), rho_val, **kw))

    def evaluate(dv):
        return model.evaluate(pressure, thickness=dv["thickness"],
                              is_pressure=True, **base)

    def aggregated_stress(p):
        return evaluate(p).aggregated_stress

    prob = OptimizationProblem(evaluate, device=device)
    prob.add_design_variable("thickness", h_val * np.ones(nel), lower=1e-2,
                             upper=10.0)
    mass_0 = rho_val * h_val * width * length
    prob.add_constraint("mass", equals=mass_0)
    prob.set_objective("compliance")
    return dict(mesh=mesh, model=model, evaluate=evaluate,
                aggregated_stress=aggregated_stress, problem=prob, kw=kw)


def main(argv=None):
    args = parse_args(argv, __doc__, maxiter=MAXITER,
                      run_check_derivatives=RUN_CHECK_DERIVATIVES)
    ex = build(args.device)
    nel = ex["mesh"].n_cells
    th0 = torch.full((nel,), h_val, **ex["kw"])
    th = th0.clone().requires_grad_(True)
    out = ex["evaluate"]({"thickness": th})
    Ix = width * h_val**3 / 12
    eb = f_d * width * length**4 / (8 * E_val * Ix) / width
    tip = float(out.disp_solid.detach().max())
    mass, agg = (float(out.mass.detach()),
                 float(out.aggregated_stress.detach()))
    print("Euler-Bernoulli beam theory deflection:", eb)
    print("Reissner-Mindlin FE deflection:", tip)
    print("mass:", mass, " aggregated stress:", agg)
    (g,) = torch.autograd.grad(out.aggregated_stress, th)
    result = {"n_dofs": ex["model"].shell_pde.W.n_dofs, "tip": tip,
              "euler_bernoulli": eb, "mass0": mass,
              "aggregated_stress0": agg,
              "compliance0": float(out.compliance.detach()),
              "grad": numpy_of(g)}
    if args.run_check_derivatives:
        result["check_totals_max_rel"] = check_totals(
            ex["aggregated_stress"], {"thickness": th0}, eps=1e-6)
    dvs, res, record = solve_recorded(ex["problem"], args.maxiter, 1e-9)
    print("optimized compliance:", res.fun, " iterations:", res.nit)
    result.update(record, thickness=numpy_of(dvs["thickness"]))
    return result


if __name__ == "__main__":
    main()
