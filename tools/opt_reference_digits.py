"""The JAX package's digits on the PAV wing thickness study, the constants
OPT_DIGITS of chip_smoke.py's `opt` phase:

    FEMO_PLATFORM=cpu FEMO_COMPILE_CACHE=0 python tools/opt_reference_digits.py [MAXITER]

femo_alpha_tpu's OptimizationProblem (scipy SLSQP) on the problem of
examples/advanced_examples/pav_shell_opt/ex_pav_wing_thickness_opt.py:
RMShellModel with penalty BCs and the file's mesh tags on
tests/data/pav_like_wing_2388.msh (2,388 quads, 35,370 dofs), E 71.7e9,
nu 0.33, rho 2780, the elliptic 4,000 Pa lift pressure; min mass/mass0
subject to aggregated_stress <= 503e6/1.5 (scaler 1.5/503e6), 2,388
thicknesses in [0.001, 0.02] from h0 = 0.005, ftol 1e-8, maxiter
MAXITER (by default 2, chip_smoke.py's OPT_MAXITER). It prints the scaled objective at each SLSQP
iteration (callback order), the final mass and aggregated stress, and
nit / nfev / njev, with the scipy version (the SLSQP trajectory depends
on it). Runs eagerly (jit=False: the same numbers without compiling the
whole band path); each evaluation solves the full system by
band-preconditioned CG, so expect ~10-20 min on 8 cores.
"""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax.numpy as jnp  # noqa: E402
import scipy  # noqa: E402

from femo_alpha_tpu.mesh import readFEAMesh  # noqa: E402
from femo_alpha_tpu.models import RMShellModel  # noqa: E402
from femo_alpha_tpu.opt import OptimizationProblem  # noqa: E402

MAXITER = 2


class RecordingProblem(OptimizationProblem):
    """Keeps the objective value of every point it evaluates, so the
    per-iteration history costs no extra solve."""

    seen: dict

    def _scalar_fn(self, name, scaler=1.0):
        vg = super()._scalar_fn(name, scaler)
        self.seen = {}

        def rec(x):
            v, g = vg(x)
            self.seen[np.asarray(x, dtype=np.float64).tobytes()] = float(v)
            return v, g

        return rec


def main():
    t_start = time.perf_counter()
    mesh = readFEAMesh(os.path.join(os.path.dirname(HERE), "tests", "data",
                                    "pav_like_wing_2388.msh"))
    nel, nn = mesh.n_cells, mesh.n_nodes
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 1] < 1e-9,
                         element_wise_material=True, record=False,
                         mesh_tags={t: np.asarray(c)
                                    for t, c in mesh.cell_tags.items()})
    span = float(np.max(mesh.coords[:, 1]))
    eta = np.clip(np.asarray(mesh.coords[:, 1]) / span, 0.0, 1.0)
    pressure = np.zeros((nn, 3))
    pressure[:, 2] = 4000.0 * np.sqrt(1.0 - eta ** 2)
    base = dict(E=jnp.full(nel, 71.7e9), nu=jnp.full(nel, 0.33),
                density=jnp.full(nel, 2780.0))
    sigma_y, safety, h0 = 503.0e6, 1.5, 0.005

    def ev(dv):
        return model.evaluate(jnp.asarray(pressure),
                              thickness=dv["thickness"], is_pressure=True,
                              **base)

    out0 = ev({"thickness": jnp.full(nel, h0)})
    mass0 = float(out0.mass)
    prob = RecordingProblem(ev, jit=False)
    prob.add_design_variable("thickness", h0 * np.ones(nel), lower=0.001,
                             upper=0.02)
    prob.add_constraint("aggregated_stress", upper=sigma_y / safety,
                        scaler=safety / sigma_y)
    prob.set_objective("mass", scaler=1.0 / mass0)
    xs = []
    maxiter = int(sys.argv[1]) if len(sys.argv) > 1 else MAXITER
    dvs, res = prob.solve(maxiter=maxiter, ftol=1e-8,
                          callback=lambda xk: xs.append(np.array(xk)),
                          report=False)
    hist = [prob.seen[x.tobytes()] for x in xs]
    out = ev({"thickness": jnp.asarray(dvs["thickness"])})
    print(f"scipy {scipy.__version__}, maxiter {maxiter}")
    print(f"mass0 {mass0:.15e}")
    print("history " + " ".join(f"{v:.15e}" for v in hist))
    print(f"mass {float(out.mass):.15e}")
    print(f"aggregated_stress {float(out.aggregated_stress):.15e}")
    print(f"nit {res.nit} nfev {res.nfev} njev {res.njev}")
    print(f"message {res.message!r}")
    print(f"seconds {time.perf_counter() - t_start:.1f}")


if __name__ == "__main__":
    main()
