"""The JAX package's results that tests/test_torch_api.py compares the
port's public names with where a live JAX call costs more than ~10 s,
written to tests/reference_digits/api.npz:

    FEMO_PLATFORM=cpu FEMO_COMPILE_CACHE=0 python tools/api_reference_digits.py

The JAX package runs on the CPU in f64 with its FEMO_* solver flags unset
(FEMO_MG_F32, FEMO_LANE_MAJOR, FEMO_HOSTLOOP, FEMO_CG_DF,
FEMO_OP_STORAGE; the script unsets them); Krylov iterations are read from
inside the solves by a debug callback.

- mg_factory: tests/test_multigrid.py's model-level case, the 32x8
  StructuredQuadMesh 10 x 2 (strong clamp at x = 0, element-wise h = 0.2,
  E = 4.32e8, nu = 0, rho = 1, f_z = 2) with the state's solver options
  replaced by {"method": "cg", "tol": 1e-11, "precond_factory":
  shell_mg_precond_factory(build_shell_mg(pde, bc, coarsest_cells=64))}
  and the state's ImplicitPDE rebuilt (FEA._build_pde; the assignment
  alone leaves the dense solve in place): the state and the CG
  iterations.
- additional_outputs: RMShellModel(additional_outputs=["stress", "mass"])
  on the 8x2 plate 10 x 2 (penalty BCs, the dense path), element-wise
  h = 0.2, E = 4.32e8, nu = 0.3, rho = 100, f_z = 2: the state and the
  compliance.
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

import femo_alpha_tpu  # noqa: E402,F401  (platform and x64 configuration)
from femo_alpha_tpu.mesh import (  # noqa: E402
    StructuredQuadMesh,
    createRectangleMesh,
)
from femo_alpha_tpu.models import RMShellModel  # noqa: E402
from femo_alpha_tpu.models.rm_shell.mg import (  # noqa: E402
    build_shell_mg,
    shell_mg_precond_factory,
)
from femo_alpha_tpu.solvers import linear  # noqa: E402

TESTS_NPZ = os.path.join(ROOT, "tests", "reference_digits", "api.npz")
SOLVES = []
_krylov = linear.LinearSolver._krylov


def _recorded(self, op, b, x0):
    x, info = _krylov(self, op, b, x0)
    jax.debug.callback(lambda it: SOLVES.append(int(it)), info["iters"],
                       ordered=True)
    return x, info


linear.LinearSolver._krylov = _recorded


def _bc(x):
    return x[:, 0] < 1e-12


def _load(m, nu, rho):
    nel, nn = m.n_cells, m.n_nodes
    p = np.zeros((nn, 3))
    p[:, 2] = 2.0
    return (jnp.asarray(p), jnp.full(nel, 0.2), jnp.full(nel, 4.32e8),
            jnp.full(nel, nu), jnp.full(nel, rho))


def mg_factory():
    m = StructuredQuadMesh(32, 8, (0, 0), (10.0, 2.0), gdim=3)
    model = RMShellModel(m, shell_bc_func=_bc, element_wise_material=True,
                         PENALTY_BC=False)
    mg = build_shell_mg(model.shell_pde, _bc, coarsest_cells=64)
    model.fea.states["disp_solid"].solver_opts = {
        "method": "cg", "tol": 1e-11,
        "precond_factory": shell_mg_precond_factory(mg)}
    model.fea._build_pde("disp_solid")
    SOLVES.clear()
    u = model.evaluate(*_load(m, 0.0, 1.0)).disp_solid
    u = np.asarray(jax.block_until_ready(u))
    jax.effects_barrier()
    return {"mg_factory_u": u, "mg_factory_iters": np.asarray(SOLVES)}


def additional_outputs():
    m = createRectangleMesh(8, 2, (0, 0), (10.0, 2.0), "quad", gdim=3)
    model = RMShellModel(m, shell_bc_func=_bc, element_wise_material=True,
                         additional_outputs=["stress", "mass"])
    out = model.evaluate(*_load(m, 0.3, 100.0))
    return {"additional_outputs_u": np.asarray(out.disp_solid),
            "additional_outputs_compliance": np.asarray(
                float(out.compliance))}


def main():
    t0 = time.perf_counter()
    out = {**mg_factory(), **additional_outputs()}
    for k, v in out.items():
        print(k, v.shape, v if v.size < 4 else "", flush=True)
    np.savez_compressed(TESTS_NPZ, **out)
    print(f"wrote {os.path.relpath(TESTS_NPZ, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
