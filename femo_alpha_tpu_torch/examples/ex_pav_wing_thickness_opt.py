"""PAV wing skin thickness optimization from a gmsh .msh file: the
structural core of the reference's PAV study (mass objective,
aggregated-stress constraint, penalty-clamped root) on the committed
pav-scale generated wing tests/data/pav_like_wing_2388.msh (2,388 quads,
35,370 dofs), under an elliptic spanwise pressure.

  RMShellModel(mesh, PENALTY_BC=True).evaluate(pressures, h, E, nu, rho)
  -> mass, aggregated_stress, disp_extracted, per-tag p-norms;
  min mass  s.t.  aggregated_stress <= sigma_y / SF,  h in [h_min, h_max]

The unstructured penalty-BC configuration is solved by CG preconditioned
by the RCM band Cholesky (solvers/band.py). The SLSQP iteration limit is
FEMO_PAV_MAXITER (default 100) unless --maxiter is given.

    python -m femo_alpha_tpu_torch.examples.ex_pav_wing_thickness_opt [--maxiter N] [--device cpu]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..adjoint import check_totals
from ..assembly.assemble import assemble_scalar
from ..mesh import readFEAMesh
from ..models import RMShellModel
from ..opt import OptimizationProblem
from ._common import data_path, f64, numpy_of, parse_args, solve_recorded

RUN_CHECK_DERIVATIVES = 0
MESH = data_path("pav_like_wing_2388.msh")
# aluminum 7075-ish (the reference PAV example's material class)
E_val, nu_val, rho_val = 71.7e9, 0.33, 2780.0
sigma_y, safety = 503.0e6, 1.5
h0, h_min, h_max = 0.005, 0.001, 0.02
PRESSURE = 4000.0  # elliptic lift amplitude, ~2.5g pull-up on 800 kg


def build(device=None):
    """The wing, its RMShellModel (penalty BCs, the file's tags),
    evaluate(dv) and the SLSQP problem. mass0, the objective's scale, is
    the mass at h0 assembled from the mass form (what evaluate's `mass`
    output assembles), so building needs no solve."""
    kw = f64(device)
    mesh = readFEAMesh(MESH)
    nel, nn = mesh.n_cells, mesh.n_nodes
    span = float(np.max(mesh.coords[:, 1]))
    # per-physical-group stress outputs (skin = 1, rib = 2)
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 1] < 1e-9,
                         element_wise_material=True, record=False,
                         mesh_tags={t: np.asarray(c)
                                    for t, c in mesh.cell_tags.items()},
                         device=device)
    eta = np.clip(np.asarray(mesh.coords[:, 1]) / span, 0.0, 1.0)
    pressure = np.zeros((nn, 3))
    pressure[:, 2] = PRESSURE * np.sqrt(1.0 - eta**2)
    pressure = torch.as_tensor(pressure, **kw)
    base = dict(E=torch.full((nel,), E_val, **kw),
                nu=torch.full((nel,), nu_val, **kw),
                density=torch.full((nel,), rho_val, **kw))

    def evaluate(dv):
        return model.evaluate(pressure, thickness=dv["thickness"],
                              is_pressure=True, **base)

    th0 = torch.full((nel,), h0, **kw)
    p = model.fe_inputs(pressure, th0, base["E"], base["nu"],
                        base["density"])
    with torch.no_grad():
        mass0 = float(assemble_scalar(model.shell_pde.mass_form(),
                                      p["thickness"],
                                      {"density": p["density"],
                                       "uhat": p["uhat"]}))
    prob = OptimizationProblem(evaluate, device=device)
    prob.add_design_variable("thickness", h0 * np.ones(nel),
                             lower=h_min, upper=h_max)
    prob.add_constraint("aggregated_stress", upper=sigma_y / safety,
                        scaler=safety / sigma_y)
    prob.set_objective("mass", scaler=1.0 / mass0)
    return dict(mesh=mesh, model=model, evaluate=evaluate, problem=prob,
                mass0=mass0, span=span, th0=th0)


def main(argv=None):
    maxiter = int(os.environ.get("FEMO_PAV_MAXITER", "100"))
    args = parse_args(argv, __doc__, maxiter=maxiter,
                      run_check_derivatives=RUN_CHECK_DERIVATIVES)
    ex = build(args.device)
    mesh, th0 = ex["mesh"], ex["th0"]
    print(f"pav wing: {mesh.n_cells} cells, {mesh.n_nodes} nodes, span "
          f"{ex['span']:.2f} m, tags {sorted(mesh.cell_tags)}")
    with torch.no_grad():
        out0 = ex["evaluate"]({"thickness": th0})
    mass0, agg0 = float(out0.mass), float(out0.aggregated_stress)
    tip0 = float(out0.disp_solid.max())
    print(f"initial: mass {mass0:.3f} kg, aggregated stress "
          f"{agg0 / 1e6:.1f} MPa, tip disp {tip0:.4f} m")
    tags = {}
    for t in sorted(mesh.cell_tags):
        p = float(out0.to_dict()[f"pnorm_stress_{t}"])
        # aggregated = (1/m) pnorm^(1/rho), m = 1e-6, rho = 100: in MPa
        # that is pnorm^0.01
        tags[t] = p ** 0.01
        print(f"  tag {t}: aggregated stress {tags[t]:.1f} MPa")
    result = {"n_dofs": ex["model"].shell_pde.W.n_dofs, "mass0": mass0,
              "aggregated_stress0": agg0, "tip0": tip0,
              **{f"tag{t}_MPa": v for t, v in tags.items()}}
    if args.run_check_derivatives:
        result["check_totals_max_rel"] = check_totals(
            lambda p: ex["evaluate"](p).aggregated_stress,
            {"thickness": th0}, eps=1e-7)
    dvs, res, record = solve_recorded(ex["problem"], args.maxiter, 1e-8)
    with torch.no_grad():
        out = ex["evaluate"](dvs)
    h_opt = numpy_of(dvs["thickness"])
    mass, agg = float(out.mass), float(out.aggregated_stress)
    print(f"optimized: mass {mass:.3f} kg ({mass / mass0:.3f}x initial), "
          f"aggregated stress {agg / 1e6:.1f} MPa (limit "
          f"{sigma_y / safety / 1e6:.1f}), h in [{h_opt.min():.4f}, "
          f"{h_opt.max():.4f}] m")
    result.update(record, thickness=h_opt, mass=mass, aggregated_stress=agg)
    return result


if __name__ == "__main__":
    main()
