"""1D cantilever beam thickness optimization (Euler-Bernoulli, Hermite
cubic, 50 elements): the forward compliance and volume, the compliance's
thickness gradient checked against central differences, and minimum
compliance at a fixed volume by SLSQP. The OpenMDAO beam example's
optimum is 23762.153677443166.

    python -m femo_alpha_tpu_torch.examples.ex_thickness_opt_cantilever_beam [--maxiter 1000] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..adjoint import check_totals
from ..models import EulerBernoulliBeamModel
from ..opt import OptimizationProblem
from ._common import f64, numpy_of, parse_args, solve_recorded

RUN_CHECK_DERIVATIVES = 1
E, L, b, h = 1.0, 1.0, 0.1, 0.1
volume = 0.01
nel = 50
MAXITER = 1000
OPENMDAO_OPTIMUM = 23762.153677443166


def build(device=None):
    """The beam model, evaluate(dv), the compliance functional of the
    derivative check and the SLSQP problem."""
    beam = EulerBernoulliBeamModel(nel=nel, L=L, E=E, width=b, tip_load=-1.0,
                                   device=device)

    def evaluate(dv):
        return beam.evaluate(dv["thickness"])

    def compliance(dv):
        return evaluate(dv).compliance

    prob = OptimizationProblem(evaluate, device=device)
    prob.add_design_variable("thickness", h * np.ones(nel), lower=1e-2,
                             upper=10.0)
    prob.set_objective("compliance")
    prob.add_constraint("volume", equals=volume)
    return dict(model=beam, evaluate=evaluate, compliance=compliance,
                problem=prob, kw=f64(device))


def main(argv=None):
    args = parse_args(argv, __doc__, maxiter=MAXITER,
                      run_check_derivatives=RUN_CHECK_DERIVATIVES)
    ex = build(args.device)
    beam, kw = ex["model"], ex["kw"]
    th0 = torch.full((nel,), h, **kw)
    t = th0.clone().requires_grad_(True)
    out = beam.evaluate(t)
    c0, v0 = float(out.compliance.detach()), float(out.volume.detach())
    print("compliance @ uniform:", c0)
    print("volume:", v0)
    (g,) = torch.autograd.grad(out.compliance, t)
    result = {"n_dofs": beam.V.n_dofs, "compliance0": c0, "volume0": v0,
              "grad": numpy_of(g)}
    if args.run_check_derivatives:
        result["check_totals_max_rel"] = check_totals(
            ex["compliance"], {"thickness": th0}, eps=1e-7, directions=3)
    dvs, res, record = solve_recorded(ex["problem"], args.maxiter, 1e-9)
    th = numpy_of(dvs["thickness"])
    print("optimized compliance:", res.fun)
    print("OpenMDAO reference:  ", OPENMDAO_OPTIMUM)
    print("optimized thickness (first 10):", th[:10])
    result.update(record, thickness=th)
    return result


if __name__ == "__main__":
    main()
