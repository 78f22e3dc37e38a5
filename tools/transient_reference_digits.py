"""The JAX package's digits on the transient gust workload, the constants
TRANSIENT_DIGITS of chip_smoke.py's `transient` phase, and
tests/reference_digits/transient_10x2.npz, the reference side of
tests/test_torch_transient.py:

    FEMO_PLATFORM=cpu FEMO_COMPILE_CACHE=0 \
        python tools/transient_reference_digits.py [dense|mg [STEPS]|tests]

The FEMO_* solver flags of the JAX package (FEMO_MG_F32, FEMO_LANE_MAJOR,
FEMO_HOSTLOOP, FEMO_CG_DF, FEMO_OP_STORAGE) are unset by the script.

femo_alpha_tpu's PlateSim (f64) at exactly the phase's inputs, which are
those of tools/transient_bench.py: the 40x20 quad plate 10 x 2
(createRectangleMesh, 12,546 dofs), clamped at x = 0, E = 4.32e8,
nu = 0, rho = 100, dt = 0.01, STEPS implicit-midpoint steps (50 by
default, the bench's workload; chip_smoke.py's phase runs 30), element-wise
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

"tests" (~1.5 min) writes what tests/test_torch_transient.py compares the
port with, at that file's inputs (the 10x2 plate 10 x 2 of
tests/test_dynamic_shell.py, E = 4.32e8, nu = 0, rho = 10, dt = 0.01,
20 steps, element-wise thickness, quad_deg 4, the dense path; the
seeded thickness and load of its `_inputs`): the displacement history,
its strain energies, tip history and p-norm history (simulate_outputs,
segment 5, (m, rho) = (1e-6, 20)), jax.grad of the total energy in the
thickness and its derivative along a seeded load-history direction; the
K and M element matrices, the inertia form's with a density field of 7,
the load at step 3 and the self weight; the K (1, 3) and M (1,) affine
bases and their vjp_theta on seeded vectors; the L2-regularized total
strain energy; the tip's point-evaluation rows; and the H1
regularization of a seeded nodal thickness, cell by cell.
"""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

for _flag in ("FEMO_MG_F32", "FEMO_LANE_MAJOR", "FEMO_HOSTLOOP", "FEMO_CG_DF",
              "FEMO_OP_STORAGE"):
    os.environ.pop(_flag, None)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from femo_alpha_tpu.mesh import createRectangleMesh  # noqa: E402
from femo_alpha_tpu.models.dynamic_rm_shell import PlateSim  # noqa: E402

TESTS_NPZ = os.path.join(os.path.dirname(HERE), "tests", "reference_digits",
                         "transient_10x2.npz")
# tests/test_torch_transient.py's fixture
E_VAL, NU, RHO, DT, N = 4.32e8, 0.0, 10.0, 0.01, 20
X_TIP = (10.0, 1.0, 0.0)


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


def test_inputs(nel, nn, steps=N, seed=0):
    """tests/test_torch_transient.py::_inputs: a seeded thickness around
    0.2 and a z-load around 2 per node that varies in time and space."""
    rng = np.random.default_rng(seed)
    th = 0.2 * (1.0 + 0.1 * rng.uniform(-1.0, 1.0, nel))
    fh = np.zeros((steps + 1, 3 * nn))
    fh[:, 2::3] = 2.0 + 0.5 * rng.standard_normal((steps + 1, nn))
    return th, fh


def tests():
    """The reference side of tests/test_torch_transient.py (see the
    module docstring)."""
    from femo_alpha_tpu.assembly.affine import AffineDesignOperator
    from femo_alpha_tpu.assembly.assemble import element_matrices
    from femo_alpha_tpu.models.dynamic_rm_shell import (
        TotalStrainEnergyOperation,
    )
    from femo_alpha_tpu.models.rm_shell.pde import RMShellPDE
    from femo_alpha_tpu.spaces.pointeval import point_eval_rows

    t0 = time.perf_counter()
    mesh = createRectangleMesh(10, 2, (0, 0), (10, 2), "quad", gdim=3)
    sim = PlateSim(mesh, E_VAL, NU, RHO, dt=DT, Nsteps=N,
                   element_wise_thickness=True, quad_deg=4)
    sim.set_up_tip_dofs(np.asarray(X_TIP))
    th_np, fh_np = test_inputs(mesh.n_cells, mesh.n_nodes)
    th, fh = jnp.asarray(th_np), jnp.asarray(fh_np)

    def total(t, f):
        wh = sim.simulate(t, f)
        se = sim.strain_energy_history(wh, t)
        return jnp.sum(se), (wh, se)

    (_, (wh, se)), (g_th, g_fh) = jax.value_and_grad(
        total, argnums=(0, 1), has_aux=True)(th, fh)
    d_fh = np.random.default_rng(1).standard_normal(fh_np.shape)
    pn = sim.simulate_outputs(th, fh, segment_len=5,
                              stress_pnorm=(1e-6, 20))["pnorm_history"]
    Ke, Me = sim._element_mats(th)
    pde = sim.pde
    Mp = element_matrices(pde.inertia_form(rho_is_param=True),
                          jnp.zeros(sim.fe_dofs),
                          {"thickness": th,
                           "density": jnp.full(sim.num_var, 7.0)})
    rng = np.random.default_rng(2)
    u, lam = (rng.standard_normal(sim.fe_dofs) for _ in range(2))
    out = {}
    for name, form, powers, extra in (
            ("K", sim.K_form, (1, 3), sim._k_params(th)),
            ("M", sim.M_form, (1,), {"rho": jnp.asarray(RHO)})):
        def params_of(t, extra=extra):
            return {**extra, "thickness": jnp.asarray(t)}

        aff = AffineDesignOperator(form, jnp.zeros(sim.fe_dofs), params_of,
                                   powers=powers, probe_scale=0.2,
                                   layout="lane")
        out[f"basis_{name}"] = np.asarray(aff.basis)
        out[f"vjp_{name}"] = np.asarray(aff.vjp_theta(
            th, jnp.asarray(u), jnp.asarray(lam), sim.W))
    ((cell, dofs, w),) = point_eval_rows(pde.V_disp, [np.asarray(X_TIP)])
    # the H1 regularization of a seeded nodal thickness, cell by cell
    rpde = RMShellPDE(mesh, inplane_deg=4)
    th_n = 0.1 + 0.05 * np.random.default_rng(5).random(mesh.n_nodes)
    conn, xs = np.asarray(mesh.conn), np.asarray(mesh.coords)
    h1 = [float(rpde.regularization_kernel("H1")(
        None, jnp.asarray(xs[conn[c]]),
        {"thickness": jnp.asarray(th_n[conn[c]])}))
        for c in range(mesh.n_cells)]
    out.update(
        wh=np.asarray(wh), g_th=np.asarray(g_th),
        dd_fh=np.asarray(float(np.sum(np.asarray(g_fh) * d_fh))),
        se=np.asarray(se), tips=np.asarray(jax.vmap(sim.tip_disp)(wh)),
        pn=np.asarray(pn), Ke=np.asarray(Ke), Me=np.asarray(Me),
        Mp=np.asarray(Mp), load=np.asarray(sim.assemble_load(fh[3])),
        sw=np.asarray(sim.self_weight_vector(th)),
        tse_l2=np.asarray(float(TotalStrainEnergyOperation(
            sim, regularization="L2").evaluate(wh, th))),
        rows_cell=np.asarray(cell), rows_dofs=np.asarray(dofs),
        rows_w=np.asarray(w), h1_cells=np.asarray(h1))
    np.savez_compressed(TESTS_NPZ, **out)
    print(f"wrote {os.path.relpath(TESTS_NPZ, os.path.dirname(HERE))} "
          f"({len(out)} arrays) in {time.perf_counter() - t0:.1f} s")


def main():
    method = sys.argv[1] if len(sys.argv) > 1 else "dense"
    if method == "tests":
        return tests()
    if method not in ("dense", "mg"):
        raise SystemExit(f"step solver {method!r}: dense, mg or tests")
    nsteps = int(sys.argv[2]) if len(sys.argv) > 2 else 50
    mesh = createRectangleMesh(40, 20, (0, 0), (10.0, 2.0), "quad", gdim=3)
    sim = PlateSim(mesh, E=4.32e8, nu=0.0, rho=100.0, dt=0.01,
                   Nsteps=nsteps, element_wise_thickness=True,
                   solver_method=method)
    fh = jnp.asarray(gust_history(mesh.n_nodes, nsteps, sim.dt))

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
