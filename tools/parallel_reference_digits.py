"""The JAX package's digits for tests/test_torch_parallel.py: every case
there run through femo_alpha_tpu's multi-device path on the 8-device
virtual CPU mesh (parallel/product.py::shard_model for the library models,
parallel/sharding.py for the demo classes):

    FEMO_PLATFORM=cpu FEMO_SETUP_CACHE=0 FEMO_COMPILE_CACHE=0 \
        python tools/parallel_reference_digits.py [case ...]

Cases (all by default; a named case reruns only that one and keeps the
other keys of the file): plate64 (RMShellModel on the 64x16 strong-BC
plate, element-wise material, MG-preconditioned CG), plate16 (the same
model on the 16x4 plate, where the dense route runs), wing (the 8x36 wing,
penalty BCs, band-preconditioned CG), sim (PlateSim 16x4, step MG with
coarsest 16 cells, 2 steps) and demo (ShardedAssembler.residual on 8x4,
ShardedShellStep.train_step on 8x2 without a preconditioner (its
"jacobi") and on 16x4 with MG (coarsest 4 cells: three levels),
ShardedPlateStep.train_step on 4x2, 2 steps; train_step runs eagerly:
jax.jit of the MG one compiled for over 40 minutes on the 8-device CPU
mesh, eagerly it takes ~11 min). Inputs are seeded here and
drawn again, in the same order, by the test file (`inputs_*`). Writes
tests/reference_digits/parallel.npz. The JAX package's solver flags
(FEMO_MG_F32, FEMO_LANE_MAJOR, FEMO_HOSTLOOP, FEMO_CG_DF, FEMO_OP_STORAGE,
FEMO_BAND_MEM_GB) are unset, and the setup cache must be off (its affine
basis key leaves out the quadrature degrees).
"""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

for _flag in ("FEMO_MG_F32", "FEMO_LANE_MAJOR", "FEMO_HOSTLOOP", "FEMO_CG_DF",
              "FEMO_OP_STORAGE", "FEMO_BAND_MEM_GB"):
    os.environ.pop(_flag, None)
os.environ.setdefault("FEMO_PLATFORM", "cpu")
os.environ.setdefault("FEMO_X64", "1")
_xf = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _xf:
    os.environ["XLA_FLAGS"] = (
        _xf + " --xla_force_host_platform_device_count=8").strip()

OUT = os.path.join(ROOT, "tests", "reference_digits", "parallel.npz")


# the inputs, shared with tests/test_torch_parallel.py (numpy only)
def inputs_model(nel, nn, load, seed=11):
    rng = np.random.default_rng(seed)
    f = np.zeros(3 * nn)
    f[2::3] = load * (1.0 + 0.1 * rng.standard_normal(nn))
    th = 0.2 * (1.0 + 0.1 * rng.uniform(size=nel))
    return (f, th, np.full(nel, 4.32e8), np.zeros(nel), np.full(nel, 100.0))


def inputs_sim(num_var, time_levels, nf, seed=12):
    rng = np.random.default_rng(seed)
    f_hist = np.zeros((time_levels, nf))
    f_hist[:, 2::3] = 2.0 * (1.0 + 0.1 * rng.standard_normal(
        (time_levels, nf // 3)))
    th = 0.1 * (1.0 + 0.1 * rng.uniform(size=num_var))
    return th, f_hist


def inputs_demo_thickness(th0, seed=13):
    rng = np.random.default_rng(seed)
    return th0 * (1.0 + 0.1 * rng.uniform(size=th0.shape[0]))


def plate_bc(x):
    return x[:, 0] < 1e-12


def wing_bc(x):
    return x[:, 1] < 1e-9


WING = dict(n_chord=8, n_span=36, rib_stations=(18,))


def main(cases):
    import jax
    import jax.numpy as jnp

    from femo_alpha_tpu.mesh import createRectangleMesh, createWingShellMesh
    from femo_alpha_tpu.models import RMShellModel
    from femo_alpha_tpu.parallel.product import make_device_mesh, shard_model

    assert len(jax.devices()) >= 8, jax.devices()
    jm = make_device_mesh(8)
    out = dict(np.load(OUT)) if os.path.exists(OUT) else {}

    def run_model(tag, model, load):
        shard_model(model, jm)
        f, th, E, nu, rho = inputs_model(model.nel, model.nn, load)

        def J(t):
            o = model.evaluate(jnp.asarray(f), t, jnp.asarray(E),
                               jnp.asarray(nu), jnp.asarray(rho),
                               is_pressure=True)
            return o.compliance, o.disp_solid

        t0 = time.perf_counter()
        (val, u), g = jax.value_and_grad(J, has_aux=True)(jnp.asarray(th))
        out[f"{tag}_J"] = np.asarray(float(val))
        out[f"{tag}_u"] = np.asarray(u)
        out[f"{tag}_g"] = np.asarray(g)
        print(f"{tag}: J {float(val)!r} |g| {np.linalg.norm(g):.6e} "
              f"n {u.shape[0]} {time.perf_counter() - t0:.1f}s", flush=True)
        np.savez(OUT, **out)

    def plate(nx, ny):
        mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad",
                                   gdim=3)
        return RMShellModel(mesh, shell_bc_func=plate_bc,
                            element_wise_material=True, PENALTY_BC=False)

    if "plate64" in cases:
        run_model("plate64", plate(64, 16), 2.0)
    if "plate16" in cases:
        run_model("plate16", plate(16, 4), 2.0)
    if "wing" in cases:
        mesh = createWingShellMesh(**WING)
        run_model("wing", RMShellModel(mesh, shell_bc_func=wing_bc,
                                       element_wise_material=True), 200.0)
    if "sim" in cases:
        from femo_alpha_tpu.models.dynamic_rm_shell import PlateSim

        mesh = createRectangleMesh(16, 4, (0, 0), (10.0, 2.0), "quad", gdim=3)
        sim = PlateSim(mesh, E=4.32e8, nu=0.0, rho=100.0, dt=0.01, Nsteps=2,
                       element_wise_thickness=True, solver_method="mg",
                       mg_coarsest_cells=16)
        shard_model(sim, jm)
        th, f_hist = inputs_sim(sim.num_var, sim.time_levels, sim.W_f.n_dofs)

        def Js(t):
            w_hist = sim.simulate(t, jnp.asarray(f_hist))
            return jnp.sum(sim.strain_energy_history(w_hist, t))

        val, g = jax.value_and_grad(Js)(jnp.asarray(th))
        out["sim_J"] = np.asarray(float(val))
        out["sim_g"] = np.asarray(g)
        print(f"sim: J {float(val)!r} |g| {np.linalg.norm(g):.6e}",
              flush=True)
        np.savez(OUT, **out)
    if "demo" in cases:
        from femo_alpha_tpu.parallel.sharding import (
            ShardedAssembler,
            ShardedPlateStep,
            ShardedShellStep,
        )

        step = ShardedShellStep(nx=8, ny=4, jmesh=jm)
        nel = step.mesh.n_cells
        th = inputs_demo_thickness(np.full(nel, 0.2))
        params = {"thickness": jnp.asarray(th),
                  "E": jnp.full(nel, 4.32e8), "nu": jnp.zeros(nel),
                  "uhat": jnp.zeros(step.pde.VU.n_dofs),
                  "F_solid": step.example_force}
        rng = np.random.default_rng(0)
        u = 1e-3 * rng.standard_normal(step.pde.W.n_dofs)
        out["demo_residual_u"] = u
        out["demo_residual"] = np.asarray(ShardedAssembler(
            step.form, jm).residual(jnp.asarray(u), params))
        for tag, kw in (("demo_shell", dict(nx=8, ny=2)),
                        ("demo_shell_mg", dict(nx=16, ny=4, precond="mg",
                                               coarsest_cells=4))):
            s = ShardedShellStep(jmesh=jm, **kw)
            th = inputs_demo_thickness(np.asarray(s.example_thickness))
            v, g = s.train_step(jnp.asarray(th), s.example_force)
            out[f"{tag}_J"] = np.asarray(float(v))
            out[f"{tag}_g"] = np.asarray(g)
            print(f"{tag}: J {float(v)!r} |g| {np.linalg.norm(g):.6e}",
                  flush=True)
        s = ShardedPlateStep(nx=4, ny=2, dt=0.01, nsteps=2, jmesh=jm)
        th = inputs_demo_thickness(np.asarray(s.example_thickness))
        v, g = s.train_step(jnp.asarray(th), s.example_f_history)
        out["demo_plate_J"] = np.asarray(float(v))
        out["demo_plate_g"] = np.asarray(g)
        print(f"demo_plate: J {float(v)!r} |g| {np.linalg.norm(g):.6e}",
              flush=True)
    np.savez(OUT, **out)
    print("wrote", OUT, sorted(out))


if __name__ == "__main__":
    ALL = ("plate64", "plate16", "wing", "sim", "demo")
    main(sys.argv[1:] or ALL)
