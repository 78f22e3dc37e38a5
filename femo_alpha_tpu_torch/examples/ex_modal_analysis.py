"""Modal analysis of a clamped shell plate (2 x 1 m, 20x10 mesh, clamped
at x = 0): six natural frequencies and mode shapes, the eigensolver's
residuals, the Euler-Bernoulli estimate of the first bending mode, the
thickness gradient of the first eigenvalue (the Rayleigh quotient at the
converged modes) and the first mode shape written as VTU. A failed VTU
write raises.

    python -m femo_alpha_tpu_torch.examples.ex_modal_analysis [--out_dir records] [--device cpu]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..io import write_vtu
from ..mesh import StructuredQuadMesh
from ..models import RMShellModel
from ._common import f64, numpy_of, parse_args

E_val, nu_val, rho_val = 7.0e10, 0.3, 2700.0
h_val = 0.01
width, length = 1.0, 2.0
NX, NY = 20, 10
OUT_DIR = "records"


def build(device=None):
    """The plate, its RMShellModel (strong BCs) and its inputs."""
    kw = f64(device)
    mesh = StructuredQuadMesh(NX, NY, (0, 0), (length, width), gdim=3)
    nel = mesh.n_cells
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 0] < 3e-16,
                         element_wise_material=True, PENALTY_BC=False,
                         device=device)
    inputs = dict(thickness=torch.full((nel,), h_val, **kw),
                  E=torch.full((nel,), E_val, **kw),
                  nu=torch.full((nel,), nu_val, **kw),
                  density=torch.full((nel,), rho_val, **kw))
    return dict(mesh=mesh, model=model, inputs=inputs, problem=None)


def main(argv=None):
    args = parse_args(argv, __doc__, out_dir=OUT_DIR)
    ex = build(args.device)
    mesh, model, x = ex["mesh"], ex["model"], ex["inputs"]
    th, E, nu, density = (x[k] for k in ("thickness", "E", "nu", "density"))
    out = model.evaluate_modal(th, E, nu, density, n_modes=6)
    freqs = numpy_of(out.frequencies)
    print("natural frequencies [Hz]:", freqs)
    res = out.res_norms
    res = numpy_of(res) if isinstance(res, torch.Tensor) else np.asarray(res)
    print("eigensolver residuals:", res, "iterations:", out.iterations)
    # cantilever-beam analogy for the first bending mode (order of
    # magnitude only: the plate carries Poisson stiffening and shear and
    # rotary inertia that the beam formula leaves out)
    I_b = h_val**3 / 12.0
    f_beam = (1.875**2 / (2 * np.pi * length**2)) * np.sqrt(
        E_val * I_b / (rho_val * h_val))
    print(f"EB cantilever estimate of mode 1: {f_beam:.2f} Hz "
          f"(FE: {float(freqs[0]):.2f} Hz)")
    # d lam_1 / d thickness by the Rayleigh quotient
    t = th.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(out.eig_fn(t, E, nu, density)[0], t)
    print("d lam1/dh: min/max", float(g.min()), float(g.max()))
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, "mode1.vtu")
    write_vtu(path, mesh,
              point_data={"mode1": numpy_of(out.modes_extracted[0])})
    print(f"wrote {path}")
    return {"n_dofs": model.shell_pde.W.n_dofs,
            "eigenvalues": numpy_of(out.eigenvalues), "frequencies": freqs,
            "euler_bernoulli_f1": f_beam, "grad": numpy_of(g),
            "vtu": path}


if __name__ == "__main__":
    main()
