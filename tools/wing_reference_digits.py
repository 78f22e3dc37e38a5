"""The JAX package's digits on the PAV wing, the constants WING_DIGITS of
chip_smoke.py's `wing` phase:

    FEMO_PLATFORM=cpu FEMO_COMPILE_CACHE=0 python tools/wing_reference_digits.py

femo_alpha_tpu's RMShellModel (penalty BCs, band-preconditioned CG, f64)
on tests/data/pav_like_wing_2388.msh at the PAV example's material and
elliptic 4,000 Pa pressure, uniform h = 0.005: prints aggregated_stress,
mass, compliance and |d aggregated_stress / d h| (2-norm over the cells).
It solves the full 35,370-dof system (about 1.3 GB of band storage), so
run it on a machine with a few GB to spare.
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from femo_alpha_tpu.mesh import readFEAMesh  # noqa: E402
from femo_alpha_tpu.models import RMShellModel  # noqa: E402


def main():
    mesh = readFEAMesh(os.path.join(os.path.dirname(HERE), "tests", "data",
                                    "pav_like_wing_2388.msh"))
    nel, nn = mesh.n_cells, mesh.n_nodes
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 1] < 1e-9,
                         element_wise_material=True,
                         mesh_tags={t: np.asarray(c)
                                    for t, c in mesh.cell_tags.items()})
    span = float(np.max(mesh.coords[:, 1]))
    eta = np.clip(np.asarray(mesh.coords[:, 1]) / span, 0.0, 1.0)
    pressure = np.zeros((nn, 3))
    pressure[:, 2] = 4000.0 * np.sqrt(1.0 - eta ** 2)
    E, nu, rho = (jnp.full(nel, v) for v in (71.7e9, 0.33, 2780.0))

    def agg(th):
        out = model.evaluate(jnp.asarray(pressure), th, E, nu, rho)
        return out.aggregated_stress, (out.mass, out.compliance)

    (a, (mass, comp)), g = jax.value_and_grad(agg, has_aux=True)(
        jnp.full(nel, 0.005))
    print(f"aggregated_stress {float(a):.9e}")
    print(f"mass {float(mass):.9e}")
    print(f"compliance {float(comp):.9e}")
    print(f"grad_norm {float(jnp.linalg.norm(g)):.9e}")


if __name__ == "__main__":
    main()
