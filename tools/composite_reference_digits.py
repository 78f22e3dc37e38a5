"""The JAX package's digits for composite CLT laminates and the BOT
reference plane: the constants COMPOSITE_DIGITS / COMPOSITE_PASSES of
chip_smoke.py's `composite` phase, and tests/reference_digits/composite.npz,
the reference side of tests/test_torch_composite.py's pinned cases:

    FEMO_PLATFORM=cpu FEMO_COMPILE_CACHE=0 python tools/composite_reference_digits.py [plate128|plate128-one-core|direct128|tests]

The JAX package runs on the CPU in f64 with its FEMO_* solver flags unset
(FEMO_MG_F32, FEMO_LANE_MAJOR, FEMO_HOSTLOOP, FEMO_CG_DF,
FEMO_OP_STORAGE; the script unsets them). Krylov iterations are read from
inside the jitted solves by a debug callback, per CG pass: the script
runs the JAX package's LinearSolver on a copy of its krylov.cg_solve,
step for step, that records the iterations of the first pass and of the
restart pass (which starts from the true residual b - A x). The restart
pass starts at the f64 evaluation floor of the residual, so its length
depends on rounding: at 128x32 the JAX package's restart pass differs
between 8 CPU threads and one core, so plate128 pins both runs. Every
laminate is
femo_alpha_tpu_torch.benchmarks.composite_laminate (numpy), handed to the
JAX package's CompositeCLT as its four arrays.

- plate128 (the default): femo_alpha_tpu's RMShellModel on the bench plate
  10 x 2 (createRectangleMesh 128x32, CG2 x CG1, 62,886 dofs), strong clamp
  at x = 0 (the MG path, every level assembled directly with its coarsened
  laminate), element-wise material, composite_clt = composite_laminate,
  f_z = 2, h = 0.2, E = 4.32e8, nu = 0.3, rho = 100 per cell: compliance,
  |dJ/dh| (2-norm over the cells), sum(dJ/dh), the adjoint's part of
  dJ/dh (dJ/dh less benchmarks.l2_regularization_grad: its 2-norm and its
  largest entry with that cell) and the CG iterations of the forward and
  adjoint solves (from zero), in all and per pass, ~1.5 min on 8 cores;
  then the same run again in a process pinned to one core
  (`taskset -c 0`; plate128-one-core is that run alone).
- direct128: the same plate's constrained system (the JAX package's
  utils/quality.py::sparse_operator) solved by SuperLU in symmetric mode
  and refined three times: the compliance at each, against the CG run's,
  and the nodal distance of the CG solution from the last (~2 min).
- tests: the same at 64x16 (16,086 dofs, MG on two levels); at 48x8 with
  penalty BCs (6,270 dofs, the band-preconditioned CG: the smallest plate
  above the dense path's 6,000 dofs); evaluate_modal(n_modes=4,
  solver="dense") of the 8x4 plate (2 x 1, E = 7e10, nu = 0.3, h = 0.02,
  rho = 2,700 per cell, its composite_laminate with x_split = 2/3); and the
  BOT reference plane on the 8x2 plate 10 x 2 (RMShellPDE(bot_plane=True),
  element-wise material): the element matrices and the elastic energy at a
  seeded state, and a dense solve through an FEA with that PDE's residual
  form (strong clamp at x = 0, seeded thickness, f_z = 2): the state and
  its compliance. The MG and band plates also keep the adjoint's part of
  dJ/dh per cell. Written to tests/reference_digits/composite.npz (~1 min).
"""

import os
import subprocess
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
from femo_alpha_tpu.mesh import createRectangleMesh  # noqa: E402
from femo_alpha_tpu.models import RMShellModel  # noqa: E402
from femo_alpha_tpu.models.rm_shell.material import CompositeCLT  # noqa: E402
from femo_alpha_tpu.solvers import krylov, linear  # noqa: E402
from femo_alpha_tpu_torch.benchmarks import (  # noqa: E402
    composite_laminate,
    l2_regularization_grad,
)

TESTS_NPZ = os.path.join(ROOT, "tests", "reference_digits", "composite.npz")
PASSES = []  # CG iterations of each pass of every solve, in order


def _cg_recording(matvec, b, x0=None, M=None, tol=1e-10, atol=0.0,
                  maxiter=1000, restarts=1):
    """femo_alpha_tpu.solvers.krylov.cg_solve, step for step, appending
    the iterations of each pass to PASSES."""
    M = M or krylov._identity
    x0 = jnp.zeros_like(b) if x0 is None else x0
    target = jnp.maximum(tol * jnp.linalg.norm(b), atol)

    def cond(state):
        x, r, z, p, rz, k = state
        return jnp.logical_and(jnp.linalg.norm(r) > target, k < maxiter)

    def body(state):
        x, r, z, p, rz, k = state
        Ap = matvec(p)
        alpha = rz / jnp.vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = jnp.vdot(r, z)
        p = z + (rz_new / rz) * p
        return (x, r, z, p, rz_new, k + 1)

    def one_pass(x, k):
        r = b - matvec(x)
        z = M(r)
        rz = jnp.vdot(r, z)
        out = jax.lax.while_loop(cond, body, (x, r, z, z, rz, k))
        jax.debug.callback(lambda n: PASSES.append(int(n)), out[5] - k,
                           ordered=True)
        return out

    x, r, z, p, rz, k = one_pass(x0, 0)
    for _ in range(max(0, restarts)):
        x, r, z, p, rz, k = one_pass(x, k)
    resnorm = jnp.linalg.norm(b - matvec(x))
    return x, {"iters": k, "resnorm": resnorm,
               "converged": resnorm <= jnp.maximum(target, 1e-300)}


linear.cg_solve = _cg_recording


def say(part, key, value):
    print(f"[{part}] {key} {value}", flush=True)


def _bc(x):
    return x[:, 0] < 1e-12


def _jax_clt(mesh, **kw):
    c = composite_laminate(mesh, **kw)
    return CompositeCLT(c.A, c.B, c.D, c.As)


def plate(nx, ny, penalty=False):
    """Compliance, |dJ/dh|, sum(dJ/dh) and the CG iterations of the bench
    plate with the phase's laminate."""
    mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad", gdim=3)
    model = RMShellModel(mesh, shell_bc_func=_bc, element_wise_material=True,
                         PENALTY_BC=penalty, composite_clt=_jax_clt(mesh))
    nn, nel = mesh.n_nodes, mesh.n_cells
    f = np.zeros((nn, 3))
    f[:, 2] = 2.0
    mat = dict(E=jnp.full(nel, 4.32e8), nu=jnp.full(nel, 0.3),
               density=jnp.full(nel, 100.0))

    def J(h):
        return jnp.reshape(model.evaluate(jnp.asarray(f), h,
                                          **mat).compliance, ())

    PASSES.clear()
    val, g = jax.value_and_grad(J)(jnp.full(nel, 0.2))
    g = np.asarray(jax.block_until_ready(g))
    jax.effects_barrier()
    passes = [PASSES[i:i + 2] for i in range(0, len(PASSES), 2)]
    # the adjoint's part of dJ/dh: dJ/dh less the closed-form L2 term
    gs = g - l2_regularization_grad(mesh, np.full(nel, 0.2))
    return dict(n_dofs=model.shell_pde.W.n_dofs, compliance=float(val),
                grad_norm=float(np.linalg.norm(g)),
                grad_sum=float(np.sum(g)),
                grad_state_norm=float(np.linalg.norm(gs)),
                grad_state_max_cell=int(np.argmax(np.abs(gs))),
                grad_state_max=float(gs[np.argmax(np.abs(gs))]),
                cg_iters=[sum(p) for p in passes], cg_passes=passes), gs


def direct(nx, ny):
    """The compliance at a SuperLU solve of the plate's system and at each
    of three refinement steps, and the CG solution's nodal distance."""
    import scipy.sparse.linalg as spla

    from femo_alpha_tpu.assembly.assemble import assemble_scalar
    from femo_alpha_tpu.utils.quality import sparse_operator

    mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad", gdim=3)
    model = RMShellModel(mesh, shell_bc_func=_bc, element_wise_material=True,
                         PENALTY_BC=False, composite_clt=_jax_clt(mesh))
    nn, nel = mesh.n_nodes, mesh.n_cells
    f = np.zeros((nn, 3))
    f[:, 2] = 2.0
    params = {"thickness": jnp.full(nel, 0.2), "E": jnp.full(nel, 4.32e8),
              "nu": jnp.full(nel, 0.3), "uhat": jnp.zeros(3 * nn),
              "F_solid": jnp.asarray(f.reshape(-1))}
    out = model.evaluate(jnp.asarray(f), params["thickness"], params["E"],
                         params["nu"], jnp.full(nel, 100.0))
    J_cg, u_cg = float(out.compliance), np.asarray(out.disp_solid)
    B, b = sparse_operator(model.fea.states["disp_solid"].pde, params)
    lu = spla.splu(B, permc_spec="MMD_AT_PLUS_A", diag_pivot_thresh=0.0,
                   options={"SymmetricMode": True})
    us = [lu.solve(b)]
    for _ in range(3):
        us.append(us[-1] + lu.solve(b - B @ us[-1]))
    cform = model.shell_pde.compliance_form()
    part = f"direct{nx}"
    say(part, "cg_compliance", f"{J_cg:.15e}")
    for i, v in enumerate(us):
        J = float(assemble_scalar(cform, jnp.asarray(v), {
            "thickness": params["thickness"], "uhat": params["uhat"]}))
        say(part, f"refinements_{i}", f"J {J:.15e} rel vs CG "
            f"{J / J_cg - 1.0:.3e}")
    nodal = np.linalg.norm(u_cg - us[-1]) / np.linalg.norm(us[-1])
    say(part, "cg_nodal_vs_refined", f"{nodal:.3e}")


def modal():
    mesh = createRectangleMesh(8, 4, (0, 0), (2.0, 1.0), "quad", gdim=3)
    nel = mesh.n_cells
    clt = _jax_clt(mesh, h=0.02, E=7.0e10, nu=0.3, x_split=2.0 / 3.0)
    model = RMShellModel(mesh, shell_bc_func=_bc, element_wise_material=True,
                         PENALTY_BC=False, composite_clt=clt)
    out = model.evaluate_modal(np.full(nel, 0.02), np.full(nel, 7.0e10),
                               np.full(nel, 0.3), np.full(nel, 2700.0),
                               n_modes=4, solver="dense")
    return np.asarray(out.eigenvalues)


def bot_inputs(n_cells, n_dofs, n_nodes):
    """Seeded inputs of the BOT-plane cases (numpy; the test makes the same
    ones): thickness, E, nu per cell, a state u, the f_z = 2 load."""
    rng = np.random.default_rng(4)
    th = 0.2 * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, n_cells))
    E = 4.32e8 * (1.0 + 0.1 * rng.uniform(-1.0, 1.0, n_cells))
    nu = 0.3 + 0.02 * rng.uniform(-1.0, 1.0, n_cells)
    u = 1e-3 * rng.standard_normal(n_dofs)
    f = np.zeros(3 * n_nodes)
    f[2::3] = 2.0
    return th, E, nu, u, f


def bot():
    from femo_alpha_tpu.assembly.assemble import (
        assemble_scalar,
        element_matrices,
    )
    from femo_alpha_tpu.fea import FEA, FEAModel
    from femo_alpha_tpu.models.rm_shell.pde import RMShellPDE
    from femo_alpha_tpu.spaces import locate_dofs_geometric

    mesh = createRectangleMesh(8, 2, (0, 0), (10.0, 2.0), "quad", gdim=3)
    pde = RMShellPDE(mesh, element_wise_material=True, bot_plane=True)
    nn, n = mesh.n_nodes, pde.W.n_dofs
    th, E, nu, u, f = bot_inputs(mesh.n_cells, n, nn)
    p = {"thickness": jnp.asarray(th), "E": jnp.asarray(E),
         "nu": jnp.asarray(nu), "uhat": jnp.zeros(3 * nn),
         "F_solid": jnp.asarray(f)}
    Ae = element_matrices(pde.make_residual_form(), jnp.zeros(n), p)
    q = {k: v for k, v in p.items() if k != "F_solid"}
    energy = assemble_scalar(pde.elastic_energy_form(), jnp.asarray(u), q)
    fea = FEA(mesh)
    for name, sp in (("thickness", pde.VT), ("F_solid", pde.VF),
                     ("E", pde.VT), ("nu", pde.VT), ("uhat", pde.VU)):
        fea.add_input(name, sp)
    fea.add_state("disp_solid", pde.make_residual_form(),
                  arguments=["thickness", "F_solid", "E", "nu", "uhat"],
                  solver_opts={"method": "dense"})
    d1 = locate_dofs_geometric(pde.V_disp, _bc)
    d2 = locate_dofs_geometric(pde.V_rot, _bc)
    fea.add_strong_bc(np.concatenate([d1, d2 + pde.V_disp.n_dofs]), 0.0)
    fea.add_output("compliance", form=pde.compliance_form(),
                   arguments=["disp_solid", "thickness", "uhat"])
    out = FEAModel(fea=[fea]).evaluate(p)
    return dict(bot_Ae=np.asarray(Ae), bot_energy=float(energy),
                bot_u=np.asarray(out.disp_solid),
                bot_compliance=float(out.compliance))


def tests():
    out = {}
    for key, (nx, ny, penalty) in (("plate64", (64, 16, False)),
                                   ("band48", (48, 8, True))):
        r, gs = plate(nx, ny, penalty)
        for k, v in r.items():
            say(key, k, v)
            out[f"{key}_{k}"] = np.asarray(v)
        out[f"{key}_grad_state"] = gs
    out["modal_eigenvalues"] = modal()
    say("modal", "eigenvalues", out["modal_eigenvalues"])
    for k, v in bot().items():
        out[k] = np.asarray(v)
        if np.ndim(v) == 0:
            say("bot", k, f"{float(v):.15e}")
    np.savez_compressed(TESTS_NPZ, **out)
    say("tests", "wrote", os.path.relpath(TESTS_NPZ, ROOT))


def main():
    part = sys.argv[1] if len(sys.argv) > 1 else "plate128"
    t0 = time.perf_counter()
    if part in ("plate128", "plate128-one-core"):
        for k, v in plate(128, 32)[0].items():
            say(part, k, f"{v:.15e}" if isinstance(v, float) else v)
        if part == "plate128":
            # the same run pinned to one core, in a process of its own
            # (XLA sizes its thread pool at start-up)
            say(part, "seconds", f"{time.perf_counter() - t0:.1f}")
            subprocess.run(["taskset", "-c", "0", sys.executable,
                            os.path.abspath(__file__), "plate128-one-core"],
                           check=True)
            return
    elif part == "direct128":
        direct(128, 32)
    elif part == "tests":
        tests()
    else:
        raise SystemExit(f"part {part!r}: plate128, plate128-one-core, "
                         "direct128 or tests")
    say(part, "seconds", f"{time.perf_counter() - t0:.1f}")


if __name__ == "__main__":
    main()
