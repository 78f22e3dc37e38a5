"""The JAX package's digits at the inputs of chip_smoke.py's `shape`,
`shape_opt` and `pressure` phases and of tests/test_torch_shape.py's
64x16 case (SHAPE_DIGITS, SHAPE_OPT_DIGITS, PRESSURE_DIGITS there):

    FEMO_PLATFORM=cpu FEMO_COMPILE_CACHE=0 python tools/shape_reference_digits.py [PART ...]

PART is one of shape, plate64, shape_opt, pressure (all by default). The
JAX package runs on the CPU in f64 with its FEMO_* solver flags unset
(FEMO_MG_F32, FEMO_LANE_MAJOR, FEMO_HOSTLOOP, FEMO_CG_DF, FEMO_OP_STORAGE;
the script unsets them):

- shape / plate64: femo_alpha_tpu's RMShellModel on the bench plate 10 x 2
  (createRectangleMesh 128x32 / 64x16, strong clamp at x = 0, the MG
  path), f_z = 2, E = 4.32e8, nu = 0, rho = 100, h = 0.2, node_disp the
  planform change of femo_alpha_tpu_torch.benchmarks.planform_shape in y;
  compliance, |dJ/d node_disp| (2-norm over (n_nodes, 3)), |dJ/dh|, the
  derivative along planform_direction (in y) and sum(dJ/dh) by jax.grad.
- shape_opt: the problem of
  examples/advanced_examples/shape_opt/ex_plate_shape_opt.py at its 32x8
  (dense path): min compliance/J0 over the y motion of every node, root
  frozen, +-0.2, ftol 1e-12, through OptimizationProblem for
  chip_smoke.py's SHAPE_MAXITER iterations; the scaled objective at each
  iteration (callback order), the compliance at the returned x,
  nit / nfev / njev and the scipy version (the trajectory depends on it).
- pressure: the PAV wing tests/data/pav_like_wing_2388.msh (penalty BCs,
  the band path) with the PAV material, h = 0.005 and the elliptic
  4,000 Pa lift given as nodal forces
  (femo_alpha_tpu_torch.benchmarks.wing_nodal_forces), is_pressure=False:
  aggregated_stress, compliance, mass, |d agg/dh| and |d agg/dF| of a
  second evaluate at the same inputs (its solve warm-started from the
  first's solution); then the same evaluate with the small in-plane
  node_disp of benchmarks.wing_sweep: aggregated_stress and compliance.
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
import scipy  # noqa: E402

from femo_alpha_tpu.mesh import createRectangleMesh, readFEAMesh  # noqa: E402
from femo_alpha_tpu.models import RMShellModel  # noqa: E402
from femo_alpha_tpu.opt import OptimizationProblem  # noqa: E402
from femo_alpha_tpu_torch.benchmarks import (  # noqa: E402
    planform_direction,
    planform_shape,
    wing_nodal_forces,
    wing_sweep,
)

SHAPE_MAXITER = 3
WING = os.path.join(os.path.dirname(HERE), "tests", "data",
                    "pav_like_wing_2388.msh")


def plate(nx, ny):
    mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad", gdim=3)
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 0] < 1e-12,
                         element_wise_material=True, PENALTY_BC=False)
    nel, nn = mesh.n_cells, mesh.n_nodes
    f = np.zeros(3 * nn)
    f[2::3] = 2.0
    mat = dict(E=jnp.full(nel, 4.32e8), nu=jnp.zeros(nel),
               density=jnp.full(nel, 100.0))
    return mesh, model, jnp.asarray(f), mat


def shape(nx, ny):
    mesh, model, f, mat = plate(nx, ny)
    nel, nn = mesh.n_cells, mesh.n_nodes
    nd0 = np.zeros((nn, 3))
    nd0[:, 1] = planform_shape(mesh.coords)

    def J(nd, th):
        return jnp.reshape(model.evaluate(f, th, node_disp=nd,
                                          **mat).compliance, ())

    val, (g_nd, g_th) = jax.value_and_grad(J, argnums=(0, 1))(
        jnp.asarray(nd0), jnp.full(nel, 0.2))
    d = planform_direction(mesh.coords)
    print(f"[{nx}x{ny}] compliance {float(val):.15e}")
    print(f"[{nx}x{ny}] grad_node_disp_norm "
          f"{float(jnp.linalg.norm(g_nd)):.15e}")
    print(f"[{nx}x{ny}] grad_thickness_norm "
          f"{float(jnp.linalg.norm(g_th)):.15e}")
    print(f"[{nx}x{ny}] dir_deriv {float(jnp.dot(g_nd[:, 1], d)):.15e}")
    print(f"[{nx}x{ny}] grad_thickness_sum {float(jnp.sum(g_th)):.15e}")


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


def shape_opt():
    mesh, model, f, mat = plate(32, 8)
    nel, nn = mesh.n_cells, mesh.n_nodes
    th = jnp.full(nel, 0.2)

    def ev(dvs):
        nd = jnp.zeros((nn, 3)).at[:, 1].set(dvs["dy"])
        return model.evaluate(f, th, node_disp=nd, is_pressure=True, **mat)

    J0 = float(ev({"dy": jnp.zeros(nn)}).compliance)
    root = np.asarray(mesh.coords[:, 0]) < 1e-12
    prob = RecordingProblem(ev, jit=False)
    prob.add_design_variable("dy", np.zeros(nn),
                             lower=np.where(root, 0.0, -0.2),
                             upper=np.where(root, 0.0, 0.2))
    prob.set_objective("compliance", scaler=1.0 / J0)
    xs = []
    dvs, res = prob.solve(maxiter=SHAPE_MAXITER, ftol=1e-12,
                          callback=lambda xk: xs.append(np.array(xk)),
                          report=False)
    hist = [prob.seen[x.tobytes()] for x in xs]
    J1 = float(ev({"dy": jnp.asarray(dvs["dy"])}).compliance)
    print(f"[shape_opt] scipy {scipy.__version__}")
    print(f"[shape_opt] J0 {J0:.15e}")
    print("[shape_opt] history " + " ".join(f"{v:.15e}" for v in hist))
    print(f"[shape_opt] compliance {J1:.15e}")
    print(f"[shape_opt] nit {res.nit} nfev {res.nfev} njev {res.njev}")
    print(f"[shape_opt] message {res.message!r}")


def pressure():
    mesh = readFEAMesh(WING)
    nel = mesh.n_cells
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 1] < 1e-9,
                         element_wise_material=True,
                         mesh_tags={t: np.asarray(c)
                                    for t, c in mesh.cell_tags.items()})
    F = jnp.asarray(wing_nodal_forces(mesh, 4000.0))
    mat = dict(E=jnp.full(nel, 71.7e9), nu=jnp.full(nel, 0.33),
               density=jnp.full(nel, 2780.0))
    th0 = jnp.full(nel, 0.005)

    def agg(th, F_):
        out = model.evaluate(F_, th, is_pressure=False, **mat)
        return out.aggregated_stress, (out.compliance, out.mass)

    # one evaluate first: the digits are those of a solve warm-started
    # from the solution at the same inputs, as the phase reads its own
    # (a penalty system's CG from zero stops ~1e-8 from the converged J)
    model.evaluate(F, th0, is_pressure=False, **mat)
    (a, (comp, mass)), (g_th, g_F) = jax.value_and_grad(
        agg, argnums=(0, 1), has_aux=True)(th0, F)
    print(f"[pressure] aggregated_stress {float(a):.15e}")
    print(f"[pressure] compliance {float(comp):.15e}")
    print(f"[pressure] mass {float(mass):.15e}")
    print(f"[pressure] grad_thickness_norm "
          f"{float(jnp.linalg.norm(g_th)):.15e}")
    print(f"[pressure] grad_force_norm {float(jnp.linalg.norm(g_F)):.15e}")
    out = model.evaluate(F, th0, node_disp=jnp.asarray(wing_sweep(mesh)),
                         is_pressure=False, **mat)
    print(f"[pressure_moved] aggregated_stress "
          f"{float(out.aggregated_stress):.15e}")
    print(f"[pressure_moved] compliance {float(out.compliance):.15e}")


def main():
    parts = sys.argv[1:] or ["shape", "plate64", "shape_opt", "pressure"]
    run = {"shape": lambda: shape(128, 32), "plate64": lambda: shape(64, 16),
           "shape_opt": shape_opt, "pressure": pressure}
    for part in parts:
        t0 = time.perf_counter()
        run[part]()
        print(f"[{part}] seconds {time.perf_counter() - t0:.1f}", flush=True)


if __name__ == "__main__":
    main()
