"""Bay-wise thickness optimization of a rib-stiffened wing shell under both
an aggregated-stress constraint and a maximum-displacement constraint (the
shell side of the reference's tiltrotor study: thickness variables per
structural bay, a stress aggregate and a displacement aggregate, through
the penalty-BC solve of an unstructured wing).

Design variables: one thickness per spanwise bay between rib stations,
split into skin and rib groups; thickness = P @ h_bay. Minimize mass
subject to aggregated stress <= 1.05 x and the p-norm (p = 20) of the
nodal |u_z| <= 0.9 x their baseline values; then report the aggregated
stress of the skin and rib tags from the per-tag p-norm outputs.

    python -m femo_alpha_tpu_torch.examples.ex_tiltrotor_like_opt [--maxiter 40] [--n_chord 6] [--n_span 12] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh import createWingShellMesh
from ..mesh.wing import RIB_TAG, SKIN_TAG
from ..models import RMShellModel
from ..models.rm_shell.model import AggregatedStressModel
from ..opt import OptimizationProblem
from ._common import bay_layout, f64, numpy_of, parse_args, solve_recorded

MAXITER = 40
N_CHORD, N_SPAN = 6, 12                  # scale freely on device
rib_stations = (4, 8)
h0 = 0.006


def build(n_chord=N_CHORD, n_span=N_SPAN, device=None):
    """The wing, its RMShellModel with per-tag outputs, evaluate(dv) and
    the SLSQP problem; `baseline` holds the outputs at h0."""
    kw = f64(device)
    mesh = createWingShellMesh(n_chord=n_chord, n_span=n_span,
                               rib_stations=rib_stations, shuffle_seed=3)
    nel, nn = mesh.n_cells, mesh.n_nodes
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 1] < 1e-9,
                         element_wise_material=True,
                         mesh_tags={t: np.asarray(idx) for t, idx in
                                    mesh.cell_tags.items()},
                         device=device)
    span = float(np.max(mesh.coords[:, 1]))
    P = torch.as_tensor(bay_layout(mesh, span, n_span, rib_stations,
                                   RIB_TAG)[0], **kw)
    n_dv = P.shape[1]
    eta = np.clip(np.asarray(mesh.coords[:, 1]) / span, 0.0, 1.0)
    pressure = np.zeros((nn, 3))
    pressure[:, 2] = 2500.0 * np.sqrt(1.0 - eta**2)  # elliptic-ish lift
    pressure = torch.as_tensor(pressure, **kw)
    base = dict(E=torch.full((nel,), 69e9, **kw),
                nu=torch.full((nel,), 0.33, **kw),
                density=torch.full((nel,), 2700.0, **kw))

    def evaluate(dv):
        th = P @ dv["h_bay"]
        out = model.evaluate(pressure, thickness=th, is_pressure=True,
                             **base)
        # smooth max-displacement aggregate (p-norm of nodal |u_z|)
        uz = out.disp_extracted[:, 2]
        p = 20.0
        out.max_disp = torch.sum(torch.abs(uz) ** p) ** (1.0 / p)
        return out

    with torch.no_grad():
        out0 = evaluate({"h_bay": torch.full((n_dv,), h0, **kw)})
    mass0, agg0, d0 = (float(out0.mass), float(out0.aggregated_stress),
                       float(out0.max_disp))
    stress_limit = 1.05 * agg0
    disp_limit = 0.9 * d0  # force both constraints into play
    prob = OptimizationProblem(evaluate, device=device)
    prob.add_design_variable("h_bay", h0 * np.ones(n_dv), lower=0.002,
                             upper=0.02)
    prob.set_objective("mass", scaler=1.0 / mass0)
    prob.add_constraint("aggregated_stress", upper=stress_limit,
                        scaler=1.0 / agg0)
    prob.add_constraint("max_disp", upper=disp_limit, scaler=1.0 / d0)
    return dict(mesh=mesh, model=model, evaluate=evaluate, problem=prob,
                baseline=out0, stress_limit=stress_limit,
                disp_limit=disp_limit)


def main(argv=None):
    args = parse_args(argv, __doc__, maxiter=MAXITER, n_chord=N_CHORD,
                      n_span=N_SPAN)
    ex = build(args.n_chord, args.n_span, args.device)
    model, out0 = ex["model"], ex["baseline"]
    mass0, agg0, d0 = (float(out0.mass), float(out0.aggregated_stress),
                       float(out0.max_disp))
    print(f"baseline: mass {mass0:.3f} kg, aggregated stress {agg0:.4g} Pa, "
          f"max disp {d0:.5f} m")
    dvs, res, record = solve_recorded(ex["problem"], args.maxiter, 1e-9)
    with torch.no_grad():
        out = ex["evaluate"](dvs)
    sl, dl = ex["stress_limit"], ex["disp_limit"]
    h = numpy_of(dvs["h_bay"])
    print(f"optimized: mass {float(out.mass):.3f} kg "
          f"(stress {float(out.aggregated_stress):.4g} <= {sl:.4g}, "
          f"max disp {float(out.max_disp):.5f} <= {dl:.5f})")
    print("bay thicknesses [skin bays..., ribs]:", np.round(h, 5))
    # per-tag stress (skin vs rib): pnorm_stress_<tag> is the raw integral
    # sum((m sigma)^rho); report it in Pa by the aggregated_stress map
    agg = AggregatedStressModel(model.m, model.rho)
    tags = {}
    for name, tag in (("skin", SKIN_TAG), ("rib", RIB_TAG)):
        tags[name] = float(agg.evaluate(getattr(out, f"pnorm_stress_{tag}")))
    print(f"aggregated stress skin (tag {SKIN_TAG}):",
          f"{tags['skin']:.4g} Pa")
    print(f"aggregated stress rib  (tag {RIB_TAG}):",
          f"{tags['rib']:.4g} Pa")
    return {"n_dofs": model.shell_pde.W.n_dofs, "mass0": mass0,
            "aggregated_stress0": agg0, "max_disp0": d0, **record,
            "h_bay": h, "mass": float(out.mass),
            "aggregated_stress": float(out.aggregated_stress),
            "max_disp": float(out.max_disp),
            "aggregated_stress_skin": tags["skin"],
            "aggregated_stress_rib": tags["rib"]}


if __name__ == "__main__":
    main()
