"""Frequency-constrained thickness optimization: minimize the mass of a
clamped shell plate (2 x 1 m, clamped at x = 0) subject to a fundamental
natural frequency 20 % above the uniform plate's. `modal_eigenvalues` is
differentiable (the eigensolve forward, the Rayleigh quotient's exact
gradient backward), so the frequency constraint sits in
OptimizationProblem beside the mass, and each SLSQP evaluation solves the
eigenproblem again.

    python -m femo_alpha_tpu_torch.examples.ex_frequency_constrained_opt [--maxiter 30] [--nx 12] [--ny 6] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..assembly.assemble import assemble_scalar
from ..mesh import StructuredQuadMesh
from ..models import RMShellModel
from ..opt import OptimizationProblem
from ._common import f64, numpy_of, parse_args, solve_recorded

E_val, nu_val, rho_val = 7.0e10, 0.3, 2700.0
h0 = 0.01
length, width = 2.0, 1.0
NX, NY = 12, 6  # each SLSQP evaluation solves the eigenproblem again
MAXITER = 30


def build(nx=NX, ny=NY, device=None):
    """The plate, its RMShellModel, evaluate(dv) -> {lam1, mass} and the
    SLSQP problem; `f0` / `target_f` are the baseline and target
    fundamental frequencies."""
    kw = f64(device)
    mesh = StructuredQuadMesh(nx, ny, (0, 0), (length, width), gdim=3)
    nel = mesh.n_cells
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 0] < 3e-16,
                         element_wise_material=True, PENALTY_BC=False,
                         device=device)
    E = torch.full((nel,), E_val, **kw)
    nu = torch.full((nel,), nu_val, **kw)
    dens = torch.full((nel,), rho_val, **kw)
    mass_form = model.shell_pde.mass_form()
    uhat0 = torch.zeros(model.shell_pde.VU.n_dofs, **kw)

    def evaluate(dv):
        th = dv["thickness"]
        lam1 = model.modal_eigenvalues(th, E, nu, dens, n_modes=1)[0]
        mass = assemble_scalar(mass_form, th, {"density": dens,
                                               "uhat": uhat0})
        return {"lam1": lam1, "mass": mass}

    th0 = torch.full((nel,), h0, **kw)
    with torch.no_grad():
        lam0 = float(evaluate({"thickness": th0})["lam1"])
        mass0 = float(evaluate({"thickness": th0})["mass"])
    f0 = np.sqrt(lam0) / (2 * np.pi)
    target_f = 1.2 * f0  # a 20 % stiffer fundamental at minimum mass
    target_lam = (2 * np.pi * target_f) ** 2
    prob = OptimizationProblem(evaluate, jit=False, device=device)
    prob.add_design_variable("thickness", h0 * np.ones(nel),
                             lower=0.5 * h0, upper=3 * h0)
    prob.set_objective("mass", scaler=1.0 / mass0)
    prob.add_constraint("lam1", lower=target_lam, scaler=1.0 / target_lam)
    return dict(mesh=mesh, model=model, evaluate=evaluate, problem=prob,
                f0=f0, target_f=target_f, lam0=lam0, mass0=mass0)


def main(argv=None):
    args = parse_args(argv, __doc__, maxiter=MAXITER, nx=NX, ny=NY)
    ex = build(args.nx, args.ny, args.device)
    f0, target_f, mass0 = ex["f0"], ex["target_f"], ex["mass0"]
    print(f"baseline fundamental: {f0:.3f} Hz; target >= {target_f:.3f} Hz")
    dvs, res, record = solve_recorded(ex["problem"], args.maxiter, 1e-8)
    with torch.no_grad():
        out = ex["evaluate"](dvs)
    f_star = float(np.sqrt(float(out["lam1"])) / (2 * np.pi))
    print(f"optimized: mass {float(out['mass']):.4f} kg "
          f"(baseline {mass0:.4f}), f1 {f_star:.3f} Hz "
          f"(target {target_f:.3f})")
    th = numpy_of(dvs["thickness"])
    print(f"thickness range: [{th.min():.5f}, {th.max():.5f}] "
          f"(root-weighted as expected for a clamped plate)")
    return {"lam0": ex["lam0"], "mass0": mass0, "f0": f0, **record,
            "thickness": th, "mass": float(out["mass"]), "f1": f_star}


if __name__ == "__main__":
    main()
