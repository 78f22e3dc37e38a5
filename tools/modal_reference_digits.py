"""The JAX package's modal digits: the constants MODAL_DIGITS of
chip_smoke.py's `modal` phase, and tests/reference_digits/modal_8x4.npz,
the reference side of tests/test_torch_modal.py's model-level cases:

    FEMO_PLATFORM=cpu FEMO_COMPILE_CACHE=0 python tools/modal_reference_digits.py [plate128|tests]

femo_alpha_tpu runs on the CPU in f64 with its FEMO_* solver flags unset
(FEMO_MG_F32, FEMO_LANE_MAJOR, FEMO_HOSTLOOP, FEMO_CG_DF,
FEMO_OP_STORAGE; the script unsets them).

- plate128 (the default): RMShellModel.evaluate_modal at exactly the
  phase's inputs: the bench plate 10 x 2 (createRectangleMesh 128x32,
  CG2 x CG1, 62,886 dofs), strong clamp at x = 0, element-wise
  E = 4.32e8, nu = 0, rho = 100, h = 0.2; n_modes = 6, solver "lobpcg"
  (preconditioned by the model's geometric-MG V-cycle, f64), tol 1e-8,
  maxiter 200, seed 0. It prints the six eigenvalues (omega^2, the
  Rayleigh quotients at the converged modes), the LOBPCG iterations and
  residual norms, and the wall time (a few minutes on 8 cores).
- tests: the 8x4 plate (2 x 1, element-wise material, strong clamp at
  x = 0) with tests/test_torch_modal.py::_inputs (seed 3), and writes
  what that file compares the port with: the dense path's 5 eigenvalues,
  frequencies and extracted modes; LOBPCG's 4 eigenvalues (tol 1e-10,
  maxiter 100, seed 0); jax.grad of the dense result's Rayleigh map of
  the first mode in thickness, E, nu and density; the penalty-BC model's 3
  LOBPCG eigenvalues (tol 1e-10); and three SLSQP iterations of the
  frequency-constrained study (jitted, its eigensolve warmed per design
  point): the objective per iteration, nit / nfev / njev and the scipy
  version, on which the trajectory depends (~2 min).
"""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

for _flag in ("FEMO_MG_F32", "FEMO_LANE_MAJOR", "FEMO_HOSTLOOP", "FEMO_CG_DF",
              "FEMO_OP_STORAGE"):
    os.environ.pop(_flag, None)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import scipy  # noqa: E402

from femo_alpha_tpu.assembly.assemble import assemble_scalar  # noqa: E402
from femo_alpha_tpu.mesh import createRectangleMesh  # noqa: E402
from femo_alpha_tpu.models import RMShellModel  # noqa: E402
from femo_alpha_tpu.opt import OptimizationProblem  # noqa: E402

TESTS_NPZ = os.path.join(ROOT, "tests", "reference_digits", "modal_8x4.npz")


def _bc(x):
    return x[:, 0] < 1e-12


def plate128():
    mesh = createRectangleMesh(128, 32, (0, 0), (10.0, 2.0), "quad", gdim=3)
    nel = mesh.n_cells
    model = RMShellModel(mesh, shell_bc_func=_bc,
                         element_wise_material=True, PENALTY_BC=False)
    out = model.evaluate_modal(np.full(nel, 0.2), np.full(nel, 4.32e8),
                               np.zeros(nel), np.full(nel, 100.0),
                               n_modes=6, solver="lobpcg", tol=1e-8,
                               maxiter=200, seed=0)
    lam = np.asarray(out.eigenvalues)
    print("eigenvalues " + " ".join(f"{v:.15e}" for v in lam))
    print(f"iterations {out.iterations}")
    print("res_norms " + " ".join(f"{v:.3e}" for v in
                                  np.asarray(out.res_norms)))


def _inputs(nel, seed=3):
    """tests/test_torch_modal.py::_inputs."""
    rng = np.random.default_rng(seed)
    th = 0.02 + 0.01 * rng.random(nel)
    E = 7.0e10 * (1.0 + 0.1 * rng.random(nel))
    return th, E, np.full(nel, 0.3), np.full(nel, 2700.0)


def _history(model, nel):
    """Three SLSQP iterations of the frequency-constrained study."""
    h0 = 0.01
    E, nu, dens = (jnp.full(nel, v) for v in (7.0e10, 0.3, 2700.0))
    mform = model.shell_pde.mass_form()
    uhat0 = jnp.zeros(model.shell_pde.VU.n_dofs)
    lam0 = float(model.modal_eigenvalues(jnp.full(nel, h0), E, nu, dens,
                                         n_modes=1)[0])
    target = (1.2 * np.sqrt(lam0)) ** 2

    def ev(dv):
        th = dv["thickness"]
        return {"lam1": model.modal_eigenvalues(th, E, nu, dens,
                                                n_modes=1)[0],
                "mass": assemble_scalar(mform, th, {"density": dens,
                                                    "uhat": uhat0})}

    def warm(dv):
        model.modal_eigenvalues(jnp.asarray(dv["thickness"]), E, nu, dens,
                                n_modes=1)

    mass0 = float(ev({"thickness": jnp.full(nel, h0)})["mass"])
    seen = {}

    class Recording(OptimizationProblem):
        def _scalar_fn(self, name, scaler=1.0):
            vg = super()._scalar_fn(name, scaler)

            def rec(x):
                v, g = vg(x)
                seen[np.asarray(x).tobytes()] = float(v)
                return v, g

            return rec

    prob = Recording(ev, jit=True, precompute=[warm])
    prob.add_design_variable("thickness", h0 * np.ones(nel), lower=0.5 * h0,
                             upper=3 * h0)
    prob.set_objective("mass", scaler=1.0 / mass0)
    prob.add_constraint("lam1", lower=target, scaler=1.0 / target)
    xs = []
    _, res = prob.solve(maxiter=3, ftol=1e-8,
                        callback=lambda x: xs.append(np.array(x)),
                        report=False)
    return ([seen[x.tobytes()] for x in xs],
            np.array([res.nit, res.nfev, res.njev]))


def tests():
    mesh = createRectangleMesh(8, 4, (0, 0), (2.0, 1.0), "quad", gdim=3)
    nel = mesh.n_cells
    model = RMShellModel(mesh, shell_bc_func=_bc,
                         element_wise_material=True, PENALTY_BC=False)
    args = _inputs(nel)
    dense = model.evaluate_modal(*args, n_modes=5, solver="dense")
    lob = model.evaluate_modal(*args, n_modes=4, solver="lobpcg", tol=1e-10,
                               maxiter=100, seed=0)
    eig_fn = dense.eig_fn
    grads = jax.jit(jax.grad(lambda a, b, c, d: eig_fn(a, b, c, d)[0],
                             argnums=(0, 1, 2, 3)))(
        *[jnp.asarray(a) for a in args])
    pen = RMShellModel(mesh, shell_bc_func=_bc,
                       element_wise_material=True).evaluate_modal(
        *args, n_modes=3, solver="lobpcg", tol=1e-10)
    hist, counts = _history(model, nel)
    out = dict(dense_eigenvalues=np.asarray(dense.eigenvalues),
               dense_frequencies=np.asarray(dense.frequencies),
               dense_modes_extracted=np.asarray(dense.modes_extracted),
               lobpcg_eigenvalues=np.asarray(lob.eigenvalues),
               grad_thickness=np.asarray(grads[0]),
               grad_E=np.asarray(grads[1]), grad_nu=np.asarray(grads[2]),
               grad_density=np.asarray(grads[3]),
               penalty_eigenvalues=np.asarray(pen.eigenvalues),
               opt_history=np.asarray(hist), opt_counts=counts,
               scipy_version=np.asarray(scipy.__version__))
    os.makedirs(os.path.dirname(TESTS_NPZ), exist_ok=True)
    np.savez_compressed(TESTS_NPZ, **out)
    print(f"wrote {os.path.relpath(TESTS_NPZ, ROOT)} (scipy "
          f"{scipy.__version__}): history {hist}, nit/nfev/njev {counts}")


def main():
    part = sys.argv[1] if len(sys.argv) > 1 else "plate128"
    t0 = time.perf_counter()
    {"plate128": plate128, "tests": tests}[part]()
    print(f"seconds {time.perf_counter() - t0:.1f}")


if __name__ == "__main__":
    main()
