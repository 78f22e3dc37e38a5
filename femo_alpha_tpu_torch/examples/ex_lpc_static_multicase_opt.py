"""Two load cases (+3g / -1g) through one wing shell model, with per-case
stress and tip-displacement constraints and a mass objective (the shell
side of the reference's lift-plus-cruise static study: max_stress 350 MPa
with scaler 1e-8, tip displacement bounded, minimum thickness 3e-4 m,
initial 0.01 m, bay-grouped skin and rib thickness variables). One
RMShellModel on an unstructured penalty-BC wing is evaluated once per
load case inside the same differentiable objective.

    python -m femo_alpha_tpu_torch.examples.ex_lpc_static_multicase_opt [--maxiter 40] [--n_chord 6] [--n_span 12] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh import createWingShellMesh
from ..mesh.wing import RIB_TAG
from ..models import RMShellModel
from ..opt import OptimizationProblem
from ._common import bay_layout, f64, numpy_of, parse_args, solve_recorded

MAX_STRESS = 350e6        # Pa
MAX_DISPLACEMENT = 0.55   # m (tightened to this small wing below)
MIN_THICKNESS = 0.0003    # m
INITIAL_THICKNESS = 0.01  # m
SYSTEM_MASS = 3617.0      # kg (sets the load scale: lift = n * m * g)
G = 9.81
MAXITER = 40
N_CHORD, N_SPAN = 6, 12   # scale freely on device
rib_stations = (4, 8)
CASE_FACTORS = {"plus_3g": 3.0, "minus_1g": -1.0}


def build(n_chord=N_CHORD, n_span=N_SPAN, device=None):
    """The wing, its RMShellModel, the two maneuver pressures,
    evaluate(dv) and the SLSQP problem; `baseline` holds the outputs at
    the initial thickness."""
    kw = f64(device)
    mesh = createWingShellMesh(n_chord=n_chord, n_span=n_span,
                               rib_stations=rib_stations, shuffle_seed=3)
    nel, nn = mesh.n_cells, mesh.n_nodes
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 1] < 1e-9,
                         element_wise_material=True, device=device)
    span = float(np.max(mesh.coords[:, 1]))
    P = torch.as_tensor(bay_layout(mesh, span, n_span, rib_stations,
                                   RIB_TAG)[0], **kw)
    n_dv = P.shape[1]
    # elliptic spanwise lift carrying n * SYSTEM_MASS / 2 * g over the
    # skin planform
    eta = np.clip(np.asarray(mesh.coords[:, 1]) / span, 0.0, 1.0)
    shape = np.sqrt(1.0 - eta**2)
    area = 1.0
    coords, conn = np.asarray(mesh.coords), np.asarray(mesh.conn)
    skin = np.asarray(mesh.cell_tags.get(1))
    planform = float(np.sum(np.linalg.norm(np.cross(
        coords[conn[skin, 1]] - coords[conn[skin, 0]],
        coords[conn[skin, 3]] - coords[conn[skin, 0]]), axis=1)))
    p1g = SYSTEM_MASS / 2.0 * G / max(planform, area)

    def maneuver_pressure(n_factor):
        p = np.zeros((nn, 3))
        p[:, 2] = n_factor * p1g * shape
        return torch.as_tensor(p, **kw)

    cases = {name: maneuver_pressure(n) for name, n in CASE_FACTORS.items()}
    base = dict(E=torch.full((nel,), 69e9, **kw),
                nu=torch.full((nel,), 0.33, **kw),
                density=torch.full((nel,), 2700.0, **kw))
    # tip = the free-end (max-span) nodes; a p-norm of |u_z| over them
    tip_nodes = np.where(np.asarray(mesh.coords[:, 1]) > span * (1 - 1e-9))[0]
    tip_idx = torch.as_tensor(tip_nodes, device=kw["device"])

    def evaluate(dv):
        th = P @ dv["h_bay"]
        out_all = None
        for name, pressure in cases.items():
            out = model.evaluate(pressure, thickness=th, is_pressure=True,
                                 **base)
            uz_tip = out.disp_extracted[tip_idx, 2]
            tip_disp = torch.sum(torch.abs(uz_tip) ** 20.0) ** (1.0 / 20.0)
            if out_all is None:
                out_all = out  # mass / volume are the same in both cases
            setattr(out_all, f"{name}_stress", out.aggregated_stress)
            setattr(out_all, f"{name}_tip_disp", tip_disp)
        return out_all

    with torch.no_grad():
        out0 = evaluate({"h_bay": torch.full((n_dv,), INITIAL_THICKNESS,
                                             **kw)})
    mass0 = float(out0.mass)
    # the small stiff wing: tighten the displacement bound so it is active
    disp_limit = min(MAX_DISPLACEMENT,
                     0.9 * float(getattr(out0, "plus_3g_tip_disp")))
    prob = OptimizationProblem(evaluate, device=device)
    prob.add_design_variable("h_bay", INITIAL_THICKNESS * np.ones(n_dv),
                             lower=MIN_THICKNESS, upper=0.02)
    prob.set_objective("mass", scaler=1.0 / mass0)
    for name in cases:
        # reference scalers: stress 1e-8, displacement 1 / limit
        prob.add_constraint(f"{name}_stress", upper=MAX_STRESS, scaler=1e-8)
        prob.add_constraint(f"{name}_tip_disp", upper=disp_limit,
                            scaler=1.0 / disp_limit)
    return dict(mesh=mesh, model=model, evaluate=evaluate, problem=prob,
                baseline=out0, disp_limit=disp_limit)


def _case_values(out):
    return {f"{name}_{k}": float(getattr(out, f"{name}_{k}"))
            for name in CASE_FACTORS for k in ("stress", "tip_disp")}


def main(argv=None):
    args = parse_args(argv, __doc__, maxiter=MAXITER, n_chord=N_CHORD,
                      n_span=N_SPAN)
    ex = build(args.n_chord, args.n_span, args.device)
    out0, dl = ex["baseline"], ex["disp_limit"]
    mass0 = float(out0.mass)
    print(f"baseline: mass {mass0:.3f} kg")
    base = _case_values(out0)
    for name in CASE_FACTORS:
        print(f"  {name}: stress {base[f'{name}_stress']:.4g} Pa, tip "
              f"|u_z| {base[f'{name}_tip_disp']:.5f} m")
    dvs, res, record = solve_recorded(ex["problem"], args.maxiter, 1e-9)
    with torch.no_grad():
        out = ex["evaluate"](dvs)
    final = _case_values(out)
    print(f"optimized: mass {float(out.mass):.3f} kg")
    for name in CASE_FACTORS:
        print(f"  {name}: stress {final[f'{name}_stress']:.4g} <= "
              f"{MAX_STRESS:.3g} Pa, tip |u_z| "
              f"{final[f'{name}_tip_disp']:.5f} <= {dl:.5f} m")
    h = numpy_of(dvs["h_bay"])
    print("bay thicknesses [skin bays..., ribs]:", np.round(h, 5))
    return {"n_dofs": ex["model"].shell_pde.W.n_dofs, "mass0": mass0,
            **{f"{k}0": v for k, v in base.items()}, "disp_limit": dl,
            **record, "h_bay": h, "mass": float(out.mass), **final}


if __name__ == "__main__":
    main()
