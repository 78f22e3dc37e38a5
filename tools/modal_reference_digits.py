"""The JAX package's digits on the 128x32 bench plate's natural
frequencies, the constants MODAL_DIGITS of chip_smoke.py's `modal` phase:

    FEMO_PLATFORM=cpu FEMO_COMPILE_CACHE=0 python tools/modal_reference_digits.py

femo_alpha_tpu's RMShellModel.evaluate_modal at exactly the phase's
inputs: the bench plate 10 x 2 (createRectangleMesh 128x32, CG2 x CG1,
62,886 dofs), strong clamp at x = 0, element-wise E = 4.32e8, nu = 0,
rho = 100, h = 0.2; n_modes = 6, solver "lobpcg" (preconditioned by the
model's geometric-MG V-cycle, f64), tol 1e-8, maxiter 200, seed 0. It
prints the six eigenvalues (omega^2, the Rayleigh quotients at the
converged modes), the LOBPCG iterations and residual norms, and the wall
time (a few minutes on 8 cores).
"""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from femo_alpha_tpu.mesh import createRectangleMesh  # noqa: E402
from femo_alpha_tpu.models import RMShellModel  # noqa: E402


def main():
    t0 = time.perf_counter()
    mesh = createRectangleMesh(128, 32, (0, 0), (10.0, 2.0), "quad", gdim=3)
    nel = mesh.n_cells
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 0] < 1e-12,
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
    print(f"seconds {time.perf_counter() - t0:.1f}")


if __name__ == "__main__":
    main()
