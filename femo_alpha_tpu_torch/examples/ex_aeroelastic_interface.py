"""The one-way aeroelastic coupling interface, without an aero stack:

  aero side -> nodal pressure field (caller node order)
  geometry side -> nodal mesh displacement (shape variables) = node_disp
  shell side <- RMShellModel.evaluate(..., node_disp=...): shape
  derivatives flow through the uhat pullbacks (J / F / gradx), with no
  remeshing
  shell side -> disp_extracted (n_nodes, 3) back to the aero fit

The gradient of the aggregated stress in both the thickness and a
spanwise-stretch shape variable, through one evaluate, on a 24x4 plate
wing-box stand-in (3 x 1 m, clamped at x = 0).

    python -m femo_alpha_tpu_torch.examples.ex_aeroelastic_interface [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh import StructuredQuadMesh
from ..models import RMShellModel
from ._common import f64, numpy_of, parse_args

span, chord = 3.0, 1.0
THICKNESS, STRETCH = 0.02, 0.1


def build(device=None):
    """The plate, its RMShellModel, the elliptic pressure, the material
    fields, shape_to_node_disp(stretch) and aggregated_stress(dvs)."""
    kw = f64(device)
    mesh = StructuredQuadMesh(24, 4, (0, 0), (span, chord), gdim=3)
    nn, nel = mesh.n_nodes, mesh.n_cells
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 0] < 1e-12,
                         element_wise_material=True, record=False,
                         device=device)
    # "VLM" pressures: an elliptic spanwise distribution
    y = mesh.coords[:, 0] / span
    cp = np.sqrt(np.clip(1 - y**2, 0, 1))
    pressure = np.zeros((nn, 3))
    pressure[:, 2] = 100.0 * cp
    pressure = torch.as_tensor(pressure, **kw)
    base = dict(E=torch.full((nel,), 69e9, **kw),
                nu=torch.full((nel,), 0.33, **kw),
                density=torch.full((nel,), 2700.0, **kw))
    eta = torch.as_tensor(mesh.coords[:, 0] / span, **kw)

    def shape_to_node_disp(stretch):
        """A toy FFD: a spanwise stretch (planform change). The uhat
        pullbacks respond to in-plane mesh motion at first order;
        out-of-plane offsets of a flat reference surface are second
        order (det(I + e_z grad w^T) = 1)."""
        z = torch.zeros_like(eta)
        return torch.stack([stretch * span * eta, z, z], dim=1)

    def evaluate(dvs):
        return model.evaluate(pressure, thickness=dvs["thickness"],
                              node_disp=shape_to_node_disp(dvs["stretch"]),
                              is_pressure=True, **base)

    def aggregated_stress(dvs):
        return evaluate(dvs).aggregated_stress.reshape(())

    return dict(mesh=mesh, model=model, pressure=pressure, material=base,
                shape_to_node_disp=shape_to_node_disp, evaluate=evaluate,
                aggregated_stress=aggregated_stress, problem=None, kw=kw)


def main(argv=None):
    args = parse_args(argv, __doc__)
    ex = build(args.device)
    nel, kw = ex["mesh"].n_cells, ex["kw"]
    # thickness sized so m sigma_vM ~ O(1) (the aggregation constant
    # m = 1e-6 expects stresses ~1e6 Pa)
    dvs = {"thickness": torch.full((nel,), THICKNESS, **kw),
           "stretch": torch.tensor(STRETCH, **kw)}
    leaves = {k: v.clone().requires_grad_(True) for k, v in dvs.items()}
    val = ex["aggregated_stress"](leaves)
    g_stretch, g_th = torch.autograd.grad(
        val, [leaves["stretch"], leaves["thickness"]])
    val = val.detach()
    print("aggregated stress:", float(val))
    print("d(stress)/d(stretch):", float(g_stretch))
    print("|d(stress)/d(thickness)|:", float(torch.linalg.norm(g_th)))
    with torch.no_grad():
        out = ex["evaluate"](dvs)
    shape = tuple(out.disp_extracted.shape)
    print("disp_extracted shape (back to the OML fit):", shape)
    return {"aggregated_stress": float(val),
            "grad_stretch": float(g_stretch), "grad_thickness":
            numpy_of(g_th), "disp_extracted_shape": shape}


if __name__ == "__main__":
    main()
