"""The JAX package's digits of the two solver-family references of
chip_smoke.py's `amg` and `mg_w` phases (AMG_REF_DIGITS, MG_W_DIGITS):

    FEMO_PLATFORM=cpu FEMO_COMPILE_CACHE=0 python tools/amg_reference_digits.py [wing|mg_w|mg_w_V|small]

Both run femo_alpha_tpu's RMShellModel on the CPU in f64 (FEMO_MG_F32,
FEMO_LANE_MAJOR, FEMO_HOSTLOOP, FEMO_CG_DF and FEMO_OP_STORAGE unset), and
each prints compliance, the 2-norm of its thickness gradient and the CG
iterations of the first call's forward and adjoint solves (both from a
zero start), read from inside the jitted solves by a debug callback:

- wing: tools/wing_bench.py's workload at its 18x66 (createWingShellMesh,
  ribs at 22 and 44, shuffle 3, 36,162 dofs; penalty BCs, elliptic
  2,000 Pa lift, E 69e9, nu 0.33, rho 2,700, h 0.006) with the band memory
  guard forced low (FEMO_BAND_MEM_GB=0.000001), so that the model selects
  the aggregation AMG (solvers/amg.py::AMGPrecondFactory). ~4 min.
- mg_w: LibraryBench(128, 32)'s model and inputs (the strong-BC
  cantilever plate, 62,886 dofs, CG + geometric MG) with the hierarchy's
  cycle set to "W" and its smoother to "schwarz" before the first call.
  `mg_w_V` gives the same with the default V-cycle and block Jacobi.
- small: the 10x24 wing of tests/test_amg.py's forced-guard case (ribs at
  12, shuffle 3; E 4.32e8, nu 0, rho 100, h 0.2, f_z 200 per node), the
  digits tests/test_torch_amg.py holds.
"""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

for flag in ("FEMO_MG_F32", "FEMO_LANE_MAJOR", "FEMO_HOSTLOOP", "FEMO_CG_DF",
             "FEMO_OP_STORAGE", "FEMO_BAND_MEM_GB"):
    os.environ.pop(flag, None)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import femo_alpha_tpu  # noqa: E402,F401  (platform and x64 configuration)
from femo_alpha_tpu.solvers import linear  # noqa: E402

SOLVES = []  # (iterations, true residual norm) of every Krylov solve
_krylov = linear.LinearSolver._krylov


def _recorded(self, op, b, x0):
    x, info = _krylov(self, op, b, x0)
    jax.debug.callback(
        lambda it, rn: SOLVES.append((int(it), float(rn))),
        info["iters"], info["resnorm"], ordered=True)
    return x, info


linear.LinearSolver._krylov = _recorded


def say(name, **kv):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def _first_call(fn, th):
    """value_and_grad of fn at th: (J, |grad|, [(iters, resnorm), ...] of
    the call's solves, seconds)."""
    SOLVES.clear()
    t0 = time.perf_counter()
    (val, _), g = jax.value_and_grad(fn, has_aux=True)(th)
    jax.block_until_ready(g)
    jax.effects_barrier()
    return (float(val), float(jnp.linalg.norm(g)), list(SOLVES),
            time.perf_counter() - t0)


def wing(n_chord=18, n_span=66):
    from femo_alpha_tpu.mesh import createWingShellMesh
    from femo_alpha_tpu.models import RMShellModel

    os.environ["FEMO_BAND_MEM_GB"] = "0.000001"
    try:
        mesh = createWingShellMesh(
            n_chord=n_chord, n_span=n_span,
            rib_stations=(n_span // 3, 2 * n_span // 3), shuffle_seed=3)
        model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 1] < 1e-9,
                             element_wise_material=True)
    finally:
        os.environ.pop("FEMO_BAND_MEM_GB")
    pc = type(model.fea.states["disp_solid"].pde._pc).__name__
    nel, nn = mesh.n_cells, mesh.n_nodes
    span = float(np.max(mesh.coords[:, 1]))
    eta = np.clip(np.asarray(mesh.coords[:, 1]) / span, 0.0, 1.0)
    pressure = np.zeros((nn, 3))
    pressure[:, 2] = 2000.0 * np.sqrt(1.0 - eta ** 2)
    pressure = jnp.asarray(pressure)
    E, nu, rho = (jnp.full(nel, v) for v in (69e9, 0.33, 2700.0))

    def obj(th):
        out = model.evaluate(pressure, th, E, nu, rho, is_pressure=True)
        return out.compliance, out.disp_solid

    J, gn, solves, s = _first_call(obj, jnp.full(nel, 0.006))
    say("wing", mesh=f"{n_chord}x{n_span}", cells=nel,
        n_dofs=model.shell_pde.W.n_dofs, precond=pc,
        compliance=f"{J:.15e}", grad_norm=f"{gn:.15e}",
        solves=solves, seconds=f"{s:.1f}")


def small():
    from femo_alpha_tpu.mesh import createWingShellMesh
    from femo_alpha_tpu.models import RMShellModel

    os.environ["FEMO_BAND_MEM_GB"] = "0.000001"
    try:
        mesh = createWingShellMesh(n_chord=10, n_span=24, rib_stations=(12,),
                                   shuffle_seed=3)
        model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 1] < 1e-9,
                             element_wise_material=True)
    finally:
        os.environ.pop("FEMO_BAND_MEM_GB")
    pc = type(model.fea.states["disp_solid"].pde._pc).__name__
    nel, nn = mesh.n_cells, mesh.n_nodes
    f = jnp.zeros(3 * nn).at[2::3].set(200.0)
    E, nu, rho = jnp.full(nel, 4.32e8), jnp.zeros(nel), jnp.full(nel, 100.0)

    def obj(th):
        out = model.evaluate(f, th, E, nu, rho, is_pressure=True)
        return out.compliance, out.disp_solid

    J, gn, solves, s = _first_call(obj, jnp.full(nel, 0.2))
    say("small", mesh="10x24", cells=nel, n_dofs=model.shell_pde.W.n_dofs,
        precond=pc, compliance=f"{J:.15e}", grad_norm=f"{gn:.15e}",
        solves=solves, seconds=f"{s:.1f}")


def mg_w(nx=128, ny=32, cycle="W", smoother="schwarz"):
    from femo_alpha_tpu.mesh import createRectangleMesh
    from femo_alpha_tpu.models import RMShellModel

    # LibraryBench's model and inputs, built here: LibraryBench stages its
    # pipeline when it is made, which would trace the solve (and fix the
    # hierarchy's cycle and smoother) before they could be set
    mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad", gdim=3)
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 0] < 1e-12,
                         element_wise_material=True, PENALTY_BC=False)
    mg = model.fea.states["disp_solid"].pde._pc.mg
    mg.cycle, mg.smoother = cycle, smoother
    nel, nn = mesh.n_cells, mesh.n_nodes
    f = jnp.zeros(3 * nn).at[2::3].set(2.0)
    E, nu, rho = jnp.full(nel, 4.32e8), jnp.zeros(nel), jnp.full(nel, 100.0)

    def obj(th):
        out = model.evaluate(f, th, E, nu, rho, is_pressure=True)
        return out.compliance, out.disp_solid

    J, gn, solves, s = _first_call(obj, jnp.full(nel, 0.2))
    say("mg_w", mesh=f"{nx}x{ny}", n_dofs=model.shell_pde.W.n_dofs,
        levels=len(mg.levels), cycle=mg.cycle, smoother=mg.smoother,
        compliance=f"{J:.15e}", grad_norm=f"{gn:.15e}", solves=solves,
        seconds=f"{s:.1f}")


def main():
    parts = sys.argv[1:] or ["wing", "mg_w"]
    for p in parts:
        {"wing": wing, "mg_w": mg_w, "small": small,
         "mg_w_V": lambda: mg_w(cycle="V", smoother="block_jacobi")}[p]()


if __name__ == "__main__":
    main()
