"""The JAX package's digits on the transient gust workload, the constants
TRANSIENT_DIGITS of chip_smoke.py's `transient` phase:

    FEMO_PLATFORM=cpu FEMO_COMPILE_CACHE=0 \
        python tools/transient_reference_digits.py [dense|mg]

femo_alpha_tpu's PlateSim (f64) at exactly the phase's inputs, which are
those of tools/transient_bench.py: the 40x20 quad plate 10 x 2
(createRectangleMesh, 12,546 dofs), clamped at x = 0, E = 4.32e8,
nu = 0, rho = 100, dt = 0.01, 50 implicit-midpoint steps, element-wise
thickness 0.1, quad_deg 3, and a 1-cos gust of f_z = 10 per node over the
first half of the horizon. It prints the total strain energy and
|d total_strain_energy / d h| (2-norm over the cells) of the history path
(simulate, then the energy form summed over the steps: the digits
chip_smoke.py pins), with the step solver and the wall time, and for the
record the total of simulate_outputs, whose per-step energy is
0.5 w^T K w by the operator: on this plate that product cancels to ~1e-8
relative (large shear stiffness against bending-dominated motion), so the
two totals differ at that level on the same trajectory.

The step solver is "dense" (one f64 Cholesky of the 12,546^2 step
operator, about 1.3 GB, reused by every step and the adjoint) unless the
argument says "mg" (the geometric-MG-preconditioned CG, no inner_iters).
"""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from femo_alpha_tpu.mesh import createRectangleMesh  # noqa: E402
from femo_alpha_tpu.models.dynamic_rm_shell import PlateSim  # noqa: E402


def gust_history(n_nodes, nsteps, dt):
    """(nsteps + 1, 3 n_nodes): f_z = 10 per node times the 1-cos pulse
    over the first half of the horizon, then zero."""
    f_base = np.zeros(3 * n_nodes)
    f_base[2::3] = 10.0
    t = np.arange(nsteps + 1) * dt
    T_gust = 0.5 * nsteps * dt
    amp = np.where(t <= T_gust,
                   0.5 * (1.0 - np.cos(2.0 * np.pi * t / T_gust)), 0.0)
    return amp[:, None] * f_base[None, :]


def main():
    method = sys.argv[1] if len(sys.argv) > 1 else "dense"
    if method not in ("dense", "mg"):
        raise SystemExit(f"step solver {method!r}: dense or mg")
    mesh = createRectangleMesh(40, 20, (0, 0), (10.0, 2.0), "quad", gdim=3)
    sim = PlateSim(mesh, E=4.32e8, nu=0.0, rho=100.0, dt=0.01, Nsteps=50,
                   element_wise_thickness=True, solver_method=method)
    fh = jnp.asarray(gust_history(mesh.n_nodes, 50, sim.dt))

    def total_energy(th):
        return jnp.sum(sim.strain_energy_history(sim.simulate(th, fh), th))

    th0 = jnp.full(sim.num_var, 0.1)
    t0 = time.perf_counter()
    e, g = jax.value_and_grad(total_energy)(th0)
    g = jax.block_until_ready(g)
    wall = time.perf_counter() - t0
    e_out = sim.simulate_outputs(th0, fh, segment_len=5)[
        "total_strain_energy"]
    print(f"solver {sim.solver_method} (mg levels "
          f"{0 if sim.mg is None else len(sim.mg.levels)}), "
          f"{sim.fe_dofs} dofs, value_and_grad {wall:.1f} s")
    print(f"total_strain_energy {float(e):.15e}")
    print(f"grad_norm {float(jnp.linalg.norm(g)):.15e}")
    print(f"simulate_outputs total_strain_energy {float(e_out):.15e} "
          f"(rel {float(e_out) / float(e) - 1.0:+.3e})")


if __name__ == "__main__":
    main()
