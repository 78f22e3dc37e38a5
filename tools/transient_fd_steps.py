"""Central differences of the transient gust workload's total strain
energy at several step sizes, against the adjoint's directional
derivative: where the truncation error meets the solve noise of the
energy, which sets the step of chip_smoke.py's transient FD check.

    python tools/transient_fd_steps.py [cpu|cuda] [r ...]

The port's PlateSim with dense step solves at the inputs of chip_smoke.py's
`transient` phase (40x20, 50 steps, h = 0.1); the steps are r * h along a
seeded standard-normal direction (default r = 2e-3 1e-3 5e-4 1e-4 1e-5).
Prints one line per step: r, FD, adjoint, relative difference.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import _gust  # noqa: E402
from femo_alpha_tpu_torch.mesh import createRectangleMesh  # noqa: E402
from femo_alpha_tpu_torch.models.dynamic_rm_shell import PlateSim  # noqa


def main():
    dev = sys.argv[1] if len(sys.argv) > 1 else "cpu"
    steps = [float(r) for r in sys.argv[2:]] or [2e-3, 1e-3, 5e-4, 1e-4,
                                                 1e-5]
    mesh = createRectangleMesh(40, 20, (0, 0), (10.0, 2.0), "quad", gdim=3)
    sim = PlateSim(mesh, E=4.32e8, nu=0.0, rho=100.0, dt=0.01, Nsteps=50,
                   element_wise_thickness=True, solver_method="dense",
                   device=dev)
    fh = torch.as_tensor(_gust(mesh.n_nodes, 50, sim.dt), device=dev)
    h0 = 0.1
    th0 = torch.full((mesh.n_cells,), h0, dtype=torch.float64, device=dev)
    th = th0.clone().requires_grad_(True)
    sim.simulate_outputs(th, fh)["total_strain_energy"].backward()
    d = torch.as_tensor(np.random.default_rng(0).standard_normal(
        mesh.n_cells), device=dev)
    ad = float(torch.dot(th.grad, d))
    for r in steps:
        eps = r * h0
        with torch.no_grad():
            e = [float(sim.simulate_outputs(th0 + s * eps * d, fh)
                       ["total_strain_energy"]) for s in (1.0, -1.0)]
        fd = (e[0] - e[1]) / (2 * eps)
        print(f"r={r:.0e} fd={fd:.12e} adjoint={ad:.12e} "
              f"rel={abs(fd - ad) / abs(fd):.3e}", flush=True)


if __name__ == "__main__":
    main()
