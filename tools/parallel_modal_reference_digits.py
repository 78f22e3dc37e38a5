"""The JAX package's 8-device digits for the modal and plain-factory cases
of tests/test_torch_parallel.py: each model split by femo_alpha_tpu's
parallel/product.py::shard_model over the 8-device virtual CPU mesh,

    FEMO_PLATFORM=cpu FEMO_SETUP_CACHE=0 FEMO_COMPILE_CACHE=0 \
        python tools/parallel_modal_reference_digits.py [case ...]

Cases (all by default; a named case reruns only that one and keeps the
other keys of the file):

- modal8: tests/test_modal.py::_setup's 8x4 plate (2 x 1, strong clamp at
  x = 0, element-wise material, seed 3; tests/test_torch_modal.py::_inputs)
  - evaluate_modal's dense route, 5 modes, and jax.grad of its Rayleigh
  map's first eigenvalue in thickness, E, nu and density; LOBPCG, 4 modes,
  tol 1e-10, maxiter 100, seed 0 (the dense solve's Cholesky as its
  preconditioner).
- modal64: the 64x16 plate 10 x 2 of tests/test_torch_parallel.py (strong
  clamp, element-wise material, its inputs_model(seed 11) thickness, E,
  nu and density), LOBPCG preconditioned by the MG V-cycle, 3 modes, tol
  1e-8, maxiter 200, seed 0.
- factory: tools/api_reference_digits.py's mg_factory case (the 32x8
  StructuredQuadMesh 10 x 2, CG at 1e-11 preconditioned by
  shell_mg_precond_factory(build_shell_mg(..., coarsest_cells=64)), the
  state's ImplicitPDE rebuilt by FEA._build_pde), split after the
  rebuild: the state and the CG iterations (read inside the solves by a
  debug callback).

Writes tests/reference_digits/parallel_modal.npz. The JAX package's solver
flags (FEMO_MG_F32, FEMO_LANE_MAJOR, FEMO_HOSTLOOP, FEMO_CG_DF,
FEMO_OP_STORAGE, FEMO_BAND_MEM_GB) are unset, and the setup cache must be
off (its affine basis key leaves out the quadrature degrees).
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

OUT = os.path.join(ROOT, "tests", "reference_digits", "parallel_modal.npz")


# the inputs, shared with tests/torch_parallel_cases.py (numpy only)
def inputs_modal(nel, seed=3):
    rng = np.random.default_rng(seed)
    th = 0.02 + 0.01 * rng.random(nel)
    E = 7.0e10 * (1.0 + 0.1 * rng.random(nel))
    return th, E, np.full(nel, 0.3), np.full(nel, 2700.0)


def inputs_model(nel, nn, load, seed=11):
    rng = np.random.default_rng(seed)
    f = np.zeros(3 * nn)
    f[2::3] = load * (1.0 + 0.1 * rng.standard_normal(nn))
    th = 0.2 * (1.0 + 0.1 * rng.uniform(size=nel))
    return (f, th, np.full(nel, 4.32e8), np.zeros(nel), np.full(nel, 100.0))


def plate_bc(x):
    return x[:, 0] < 1e-12


def main(cases):
    import jax
    import jax.numpy as jnp

    from femo_alpha_tpu.mesh import StructuredQuadMesh, createRectangleMesh
    from femo_alpha_tpu.models import RMShellModel
    from femo_alpha_tpu.parallel.product import make_device_mesh, shard_model

    assert len(jax.devices()) >= 8, jax.devices()
    jm = make_device_mesh(8)
    out = dict(np.load(OUT)) if os.path.exists(OUT) else {}

    def save():
        np.savez(OUT, **out)

    if "modal8" in cases:
        mesh = createRectangleMesh(8, 4, (0, 0), (2.0, 1.0), "quad", gdim=3)
        model = RMShellModel(mesh, shell_bc_func=plate_bc,
                             element_wise_material=True, PENALTY_BC=False)
        shard_model(model, jm)
        args = [jnp.asarray(a) for a in inputs_modal(mesh.n_cells)]
        t0 = time.perf_counter()
        dense = model.evaluate_modal(*args, n_modes=5, solver="dense")
        eig_fn = dense.eig_fn
        grads = jax.grad(lambda a, b, c, d: eig_fn(a, b, c, d)[0],
                         argnums=(0, 1, 2, 3))(*args)
        lob = model.evaluate_modal(*args, n_modes=4, solver="lobpcg",
                                   tol=1e-10, maxiter=100, seed=0)
        out["modal8_dense_eigenvalues"] = np.asarray(dense.eigenvalues)
        for k, g in zip(("thickness", "E", "nu", "density"), grads):
            out[f"modal8_grad_{k}"] = np.asarray(g)
        out["modal8_lobpcg_eigenvalues"] = np.asarray(lob.eigenvalues)
        print(f"modal8: dense {np.asarray(dense.eigenvalues)!r} lobpcg "
              f"{np.asarray(lob.eigenvalues)!r} "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        save()
    if "modal64" in cases:
        mesh = createRectangleMesh(64, 16, (0, 0), (10.0, 2.0), "quad",
                                   gdim=3)
        model = RMShellModel(mesh, shell_bc_func=plate_bc,
                             element_wise_material=True, PENALTY_BC=False)
        shard_model(model, jm)
        _, th, E, nu, rho = inputs_model(mesh.n_cells, mesh.n_nodes, 2.0)
        t0 = time.perf_counter()
        o = model.evaluate_modal(*[jnp.asarray(a) for a in (th, E, nu, rho)],
                                 n_modes=3, solver="lobpcg", tol=1e-8,
                                 maxiter=200, seed=0)
        out["modal64_eigenvalues"] = np.asarray(o.eigenvalues)
        out["modal64_iterations"] = np.asarray(int(o.iterations))
        print(f"modal64: {np.asarray(o.eigenvalues)!r} iterations "
              f"{int(o.iterations)} {time.perf_counter() - t0:.1f}s",
              flush=True)
        save()
    if "factory" in cases:
        from femo_alpha_tpu.models.rm_shell.mg import (
            build_shell_mg,
            shell_mg_precond_factory,
        )
        from femo_alpha_tpu.solvers import linear

        solves = []
        krylov = linear.LinearSolver._krylov

        def recorded(self, op, b, x0):
            x, info = krylov(self, op, b, x0)
            jax.debug.callback(lambda it: solves.append(int(it)),
                               info["iters"], ordered=True)
            return x, info

        linear.LinearSolver._krylov = recorded
        m = StructuredQuadMesh(32, 8, (0, 0), (10.0, 2.0), gdim=3)
        nel, nn = m.n_cells, m.n_nodes
        model = RMShellModel(m, shell_bc_func=plate_bc,
                             element_wise_material=True, PENALTY_BC=False)
        mg = build_shell_mg(model.shell_pde, plate_bc, coarsest_cells=64)
        model.fea.states["disp_solid"].solver_opts = {
            "method": "cg", "tol": 1e-11,
            "precond_factory": shell_mg_precond_factory(mg)}
        model.fea._build_pde("disp_solid")
        shard_model(model, jm)
        p = np.zeros((nn, 3))
        p[:, 2] = 2.0
        t0 = time.perf_counter()
        u = model.evaluate(jnp.asarray(p), jnp.full(nel, 0.2),
                           jnp.full(nel, 4.32e8), jnp.zeros(nel),
                           jnp.ones(nel)).disp_solid
        u = np.asarray(jax.block_until_ready(u))
        jax.effects_barrier()
        linear.LinearSolver._krylov = krylov
        out["factory_u"] = u
        out["factory_iters"] = np.asarray(solves)
        print(f"factory: |u| {np.linalg.norm(u):.15e} iters {solves} "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        save()
    print("wrote", OUT, sorted(out))


if __name__ == "__main__":
    main(sys.argv[1:] or ("modal8", "modal64", "factory"))
