"""The JAX package's digits at the inputs of chip_smoke.py's `nodal` phase,
of the extra_residual case of its `poisson` phase, and of
tests/test_torch_nodal.py's pinned cases (NODAL_DIGITS, NODAL_SIM_DIGITS,
EXTRA_RESIDUAL_DIGITS there):

    FEMO_PLATFORM=cpu FEMO_COMPILE_CACHE=0 python tools/nodal_reference_digits.py [PART ...]

PART is one of plate64, plate128, sim40, sim8, extra256, modal (all by
default). The JAX package runs on the CPU in f64 with its FEMO_* solver
flags unset (FEMO_MG_F32, FEMO_LANE_MAJOR, FEMO_HOSTLOOP, FEMO_CG_DF,
FEMO_OP_STORAGE; the script unsets them); Krylov iterations are read from
inside the jitted solves by a debug callback:

- plate64 / plate128: femo_alpha_tpu's RMShellModel with its default,
  nodal (CG1) material, on the bench plate 10 x 2 (createRectangleMesh
  64x16 / 128x32, strong clamp at x = 0, the MG path with every level
  assembled directly), f_z = 2, E = 4.32e8, nu = 0, rho = 100 per node and
  the smooth nodal thickness femo_alpha_tpu_torch.benchmarks.
  nodal_thickness (h0 = 0.2); compliance, |dJ/dh| (2-norm over the
  nodes), sum(dJ/dh) and the CG iterations of the forward and adjoint
  solves (from zero).
- sim40 / sim8: femo_alpha_tpu's PlateSim with its default, nodal
  thickness, on tools/transient_bench.py's plate (40x20, 12,546 dofs; sim8:
  8x4) clamped at x = 0, E = 4.32e8, nu = 0, rho = 100, dt = 0.01, the
  gust of femo_alpha_tpu_torch.benchmarks.gust_history cut to 10 steps
  (sim8: 3), quad_deg 3, thickness nodal_thickness(h0 = 0.1); the dense
  step solver; the total strain energy of the history path (simulate,
  then the energy form summed over the levels) and its |d/dh|.
- extra256: the PoissonModel form (P1 on createUnitSquareMesh(256, 256,
  "triangle"), 66,049 dofs) registered in a new FEA with
  extra_residual = 50 u, the same strong BCs and {"method": "cg",
  "tol": 1e-12}, evaluated through FEAModel; kappa = 1 + U[0, 1) (DG0)
  and f = U[0, 1) (P1) drawn in that order from
  numpy.random.default_rng(0); compliance f . u, |u|_2, max |u|,
  |dJ/dkappa|, |dJ/df| and the CG iterations.
- modal: the 8x4 plate (2 x 1) of tests/test_torch_modal.py, nodal
  material (RMShellModel's default), strong clamp at x = 0; the smooth
  thickness 0.02 (1 + 0.3 sin(pi x / 2) cos(pi y)), E = 7e10, nu = 0.3,
  rho = 2,700 per node; evaluate_modal(n_modes=5, solver="dense"): the
  eigenvalues.
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

import femo_alpha_tpu  # noqa: E402,F401  (platform and x64 configuration)
from femo_alpha_tpu.solvers import linear  # noqa: E402
from femo_alpha_tpu_torch.benchmarks import (  # noqa: E402
    gust_history,
    nodal_thickness,
)

SOLVES = []  # CG iterations of every Krylov solve
_krylov = linear.LinearSolver._krylov


def _recorded(self, op, b, x0):
    x, info = _krylov(self, op, b, x0)
    jax.debug.callback(lambda it: SOLVES.append(int(it)), info["iters"],
                       ordered=True)
    return x, info


linear.LinearSolver._krylov = _recorded


def say(part, key, value):
    print(f"[{part}] {key} {value}", flush=True)


def plate(nx, ny):
    from femo_alpha_tpu.mesh import createRectangleMesh
    from femo_alpha_tpu.models import RMShellModel

    part = f"plate{nx}"
    mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad", gdim=3)
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 0] < 1e-12,
                         PENALTY_BC=False)
    nn = mesh.n_nodes
    f = np.zeros((nn, 3))
    f[:, 2] = 2.0
    th = nodal_thickness(np.asarray(mesh.coords))
    mat = dict(E=jnp.full(nn, 4.32e8), nu=jnp.zeros(nn),
               density=jnp.full(nn, 100.0))

    def J(h):
        return jnp.reshape(model.evaluate(jnp.asarray(f), h,
                                          **mat).compliance, ())

    SOLVES.clear()
    val, g = jax.value_and_grad(J)(jnp.asarray(th))
    g = jax.block_until_ready(g)
    jax.effects_barrier()
    say(part, "n_dofs", model.shell_pde.W.n_dofs)
    say(part, "compliance", f"{float(val):.15e}")
    say(part, "grad_norm", f"{float(jnp.linalg.norm(g)):.15e}")
    say(part, "grad_sum", f"{float(jnp.sum(g)):.15e}")
    say(part, "cg_iters", list(SOLVES))


def sim(nx, ny, nsteps):
    from femo_alpha_tpu.mesh import createRectangleMesh
    from femo_alpha_tpu.models.dynamic_rm_shell import PlateSim

    part = f"sim{nx}"
    mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad", gdim=3)
    s = PlateSim(mesh, E=4.32e8, nu=0.0, rho=100.0, dt=0.01, Nsteps=nsteps,
                 solver_method="dense")
    fh = jnp.asarray(gust_history(mesh.n_nodes, nsteps, s.dt))
    th = jnp.asarray(nodal_thickness(np.asarray(mesh.coords), h0=0.1))

    def total_energy(h):
        return jnp.sum(s.strain_energy_history(s.simulate(h, fh), h))

    e, g = jax.value_and_grad(total_energy)(th)
    g = jax.block_until_ready(g)
    say(part, "n_dofs", s.fe_dofs)
    say(part, "total_strain_energy", f"{float(e):.15e}")
    say(part, "grad_norm", f"{float(jnp.linalg.norm(g)):.15e}")
    say(part, "grad_sum", f"{float(jnp.sum(g)):.15e}")


def extra(n, c=50.0):
    from femo_alpha_tpu.fea import FEA, FEAModel
    from femo_alpha_tpu.mesh import createUnitSquareMesh
    from femo_alpha_tpu.models import PoissonModel

    part = f"extra{n}"
    m = PoissonModel(createUnitSquareMesh(n, n, "triangle"))
    fea = FEA(m.mesh)
    fea.add_input("kappa", m.K)
    fea.add_input("f", m.V)
    fea.add_state("u", m.fea.states["u"].form, arguments=["kappa", "f"],
                  extra_residual=lambda u, p: c * u,
                  solver_opts={"method": "cg", "tol": 1e-12})
    for bc in m.fea.bcs:
        fea.add_strong_bc(bc.dofs, bc.values)
    fea.add_output("compliance", fn=lambda v: jnp.dot(v["f"], v["u"]))
    model = FEAModel(fea=[fea])
    rng = np.random.default_rng(0)
    kappa = jnp.asarray(1.0 + rng.random(m.K.n_dofs))
    f = jnp.asarray(rng.random(m.V.n_dofs))

    def J(k, f_):
        out = model.evaluate({"kappa": k, "f": f_})
        return out.compliance, out.u

    SOLVES.clear()
    (val, u), (gk, gf) = jax.value_and_grad(J, argnums=(0, 1),
                                            has_aux=True)(kappa, f)
    gf = jax.block_until_ready(gf)
    jax.effects_barrier()
    say(part, "n_dofs", m.V.n_dofs)
    say(part, "compliance", f"{float(val):.15e}")
    say(part, "u_norm", f"{float(jnp.linalg.norm(u)):.15e}")
    say(part, "u_max", f"{float(jnp.max(jnp.abs(u))):.15e}")
    say(part, "grad_kappa_norm", f"{float(jnp.linalg.norm(gk)):.15e}")
    say(part, "grad_f_norm", f"{float(jnp.linalg.norm(gf)):.15e}")
    say(part, "cg_iters", list(SOLVES))


def modal():
    from femo_alpha_tpu.mesh import createRectangleMesh
    from femo_alpha_tpu.models import RMShellModel

    mesh = createRectangleMesh(8, 4, (0, 0), (2.0, 1.0), "quad", gdim=3)
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 0] < 1e-12,
                         PENALTY_BC=False)
    x = np.asarray(mesh.coords)
    nn = mesh.n_nodes
    th = 0.02 * (1.0 + 0.3 * np.sin(np.pi * x[:, 0] / 2.0)
                 * np.cos(np.pi * x[:, 1]))
    out = model.evaluate_modal(th, np.full(nn, 7.0e10), np.full(nn, 0.3),
                               np.full(nn, 2700.0), n_modes=5,
                               solver="dense")
    say("modal", "eigenvalues", " ".join(
        f"{v:.15e}" for v in np.asarray(out.eigenvalues)))


def main():
    parts = sys.argv[1:] or ["plate64", "plate128", "sim40", "sim8",
                             "extra256", "modal"]
    run = {"plate64": lambda: plate(64, 16),
           "plate128": lambda: plate(128, 32),
           "sim40": lambda: sim(40, 20, 10), "sim8": lambda: sim(8, 4, 3),
           "extra256": lambda: extra(256), "modal": modal}
    for part in parts:
        t0 = time.perf_counter()
        run[part]()
        say(part, "seconds", f"{time.perf_counter() - t0:.1f}")


if __name__ == "__main__":
    main()
