"""The JAX package's digits for its f32 solver configuration: the constants
F32_* of chip_smoke.py's `f32` phase, and tests/reference_digits/f32.npz,
the reference side of tests/test_torch_f32.py:

    FEMO_PLATFORM=cpu python tools/f32_reference_digits.py [tests [case ...]|chip|amg-span]

The script runs the JAX package on the CPU with FEMO_SETUP_CACHE=0 and
FEMO_COMPILE_CACHE=0 (it sets both itself) and its other FEMO_* solver
flags unset (FEMO_MG_F32, FEMO_LANE_MAJOR, FEMO_HOSTLOOP, FEMO_CG_DF,
FEMO_OP_STORAGE, FEMO_BAND_MEM_GB) except where a case names one. Krylov
iterations are read from inside the jitted solves by a debug callback, per
CG pass (the first and the restart from the true residual), on a copy of
the JAX package's krylov.cg_solve, step for step; each solve's converged
flag and true relative residual likewise. The f32 configuration is
selected only as the JAX package lets a user select it on the CPU:

- mg: FEMO_MG_F32=1 (the f32 geometric-MG hierarchy: f32 RMShellPDE and
  f32 affine bases per level, ShellMGPrecond(dtype=float32)) on the
  strong-BC cantilever of LibraryBench (10 x 2, f_z = 2 per node,
  E = 4.32e8, nu = 0, rho = 100, h = 0.2 per cell);
- storage: FEMO_OP_STORAGE=f32 (the fine operator's affine basis rounded
  to f32, the f64 hierarchy) on the same plate, with the cell-major
  operator (the JAX package's CPU layout: f32 entries applied in f64) and
  with FEMO_LANE_MAJOR=1 (its TPU layout: the per-cell product in f32,
  the vector cast down and back, which is what the port's lane-major
  fused operator does);
- band: BandCholPrecond(dtype=float32, shift=1e-5) as the preconditioner of
  cg_solve(tol=1e-8, maxiter=60) on a penalty wing's assembled system (cell
  and facet blocks, unconstrained) with a seeded right-hand side, as
  tests/test_band.py::test_band_f32_precond_cg runs it; plus whether the
  unshifted f32 factor is finite (the guard did not fire);
- amg: the 10x24 wing of tests/test_amg.py with the band guard forced low
  (FEMO_BAND_MEM_GB=0.000001) and the model's AMGPrecondFactory given
  dtype=float32 before the first call;
- sim: PlateSim (element-wise thickness 0.1, E = 4.32e8, nu = 0,
  rho = 100, dt = 0.01, benchmarks.gust_history) with
  solver_method="mg" and its hierarchy rebuilt by
  build_platesim_mg(sim, dtype=float32) before the first call; the total
  strain energy of the history path and its thickness gradient, and the CG
  iterations of every step solve (forward, then the adjoint's);
- affine (tests only): AffineDesignOperator on the 4x2 plate, its
  matvec and its astype(float32).matvec at a seeded design and vector.

Parts:
- tests (~17 min on 8 cores): mg, storage (both layouts) and f64 at
  64x16 (16,086 dofs, MG on 2 levels), band on the 8x36 wing of
  tests/test_torch_band.py (8,823 dofs), amg at 10x24, sim on a 16x8
  plate (mg_coarsest_cells 16: 2 levels) over 4 steps, affine, and
  amg6: AggregationAMG's f32 and f64 setups on the 6x8 wing of
  tests/test_torch_amg.py (root clamped) and one apply each; the MG and
  storage passes also from processes pinned to 1 and to 4 cores
  (`taskset`), whose spread is the rounding span the tests hold the port
  to. Written to tests/reference_digits/f32.npz; `tests case ...` reruns
  the cases named (plates, f64, band, amg, amg6, sim, affine) and keeps
  the other arrays.
- chip (~40 min on 8 cores): f64, mg and storage (cell-major and
  lane-major) at 128x32 (62,886 dofs, MG on 3 levels), the last three
  from 1, 4 and all cores;
  band on the 18x66 wing of tools/wing_bench.py, unshuffled (36,162
  dofs; h 0.006, E 69e9, nu 0.33); amg at 10x24; sim on the 40x20 plate
  over 5 steps.
  Printed, one line per case.
- amg-span (~8 min): the f32 AMG's CG iterations on the 10x24 wing again,
  from processes pinned to 1 and to 4 cores.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

_FLAGS = ("FEMO_MG_F32", "FEMO_LANE_MAJOR", "FEMO_HOSTLOOP", "FEMO_CG_DF",
          "FEMO_OP_STORAGE", "FEMO_BAND_MEM_GB")
for _flag in _FLAGS:
    os.environ.pop(_flag, None)
os.environ["FEMO_SETUP_CACHE"] = "0"
os.environ["FEMO_COMPILE_CACHE"] = "0"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import femo_alpha_tpu  # noqa: E402,F401  (platform and x64 configuration)
from femo_alpha_tpu.solvers import krylov, linear  # noqa: E402

TESTS_NPZ = os.path.join(ROOT, "tests", "reference_digits", "f32.npz")
SOLVES = []  # one dict per Krylov solve: passes, converged, rel


def _cg_recording(matvec, b, x0=None, M=None, tol=1e-10, atol=0.0,
                  maxiter=1000, restarts=1):
    """femo_alpha_tpu.solvers.krylov.cg_solve, step for step, recording
    each solve's passes, converged flag and true relative residual."""
    M = M or krylov._identity
    x0 = jnp.zeros_like(b) if x0 is None else x0
    bn = jnp.linalg.norm(b)
    target = jnp.maximum(tol * bn, atol)

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

    passes = []
    x, k = x0, 0
    for _ in range(1 + max(0, restarts)):
        r = b - matvec(x)
        z = M(r)
        rz = jnp.vdot(r, z)
        out = jax.lax.while_loop(cond, body, (x, r, z, z, rz, k))
        passes.append(out[5] - k)
        x, k = out[0], out[5]
    resnorm = jnp.linalg.norm(b - matvec(x))
    converged = resnorm <= jnp.maximum(target, 1e-300)
    jax.debug.callback(
        lambda ps, c, rel: SOLVES.append(dict(
            passes=[int(p) for p in ps], converged=bool(c),
            rel=float(rel))),
        jnp.stack(passes), converged, resnorm / bn, ordered=True)
    return x, {"iters": k, "resnorm": resnorm, "converged": converged}


linear.cg_solve = _cg_recording
krylov.cg_solve = _cg_recording


def say(part, **kv):
    print(f"[{part}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def _flags(**env):
    for f in _FLAGS:
        os.environ.pop(f, None)
    os.environ.update(env)


# ------------------------------------------------------------ the plates
def plate(nx, ny, **env):
    """LibraryBench's model and inputs at nx x ny with the FEMO_* flags
    `env` set at construction: value_and_grad of the compliance from a zero
    start, then the state. Returns a dict (J, grad, u, passes of the
    forward and adjoint solves, their converged flags and rel residuals)."""
    from femo_alpha_tpu.mesh import createRectangleMesh
    from femo_alpha_tpu.models import RMShellModel

    _flags(**env)
    try:
        mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad",
                                   gdim=3)
        model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 0] < 1e-12,
                             element_wise_material=True, PENALTY_BC=False)
    finally:
        _flags()
    spde = model.fea.states["disp_solid"].pde
    mg = getattr(spde._pc, "mg", None)
    nel, nn = mesh.n_cells, mesh.n_nodes
    f = jnp.zeros(3 * nn).at[2::3].set(2.0)
    E, nu, rho = jnp.full(nel, 4.32e8), jnp.zeros(nel), jnp.full(nel, 100.0)

    def J(th):
        out = model.evaluate(f, th, E, nu, rho, is_pressure=True)
        return jnp.reshape(out.compliance, ()), out.disp_solid

    SOLVES.clear()
    t0 = time.perf_counter()
    (val, u), g = jax.value_and_grad(J, has_aux=True)(jnp.full(nel, 0.2))
    g = np.asarray(jax.block_until_ready(g))
    jax.effects_barrier()
    wall = time.perf_counter() - t0
    solves = list(SOLVES)
    return dict(J=float(val), grad=g, u=np.asarray(u),
                passes=np.asarray([s["passes"] for s in solves]),
                converged=np.asarray([s["converged"] for s in solves]),
                rel=np.asarray([s["rel"] for s in solves]),
                n_dofs=model.shell_pde.W.n_dofs,
                levels=0 if mg is None else len(mg.levels),
                mg_dtype=str(None if mg is None else
                             spde._pc.dtype), wall_s=wall)


PLATE_CASES = {"mg": dict(FEMO_MG_F32="1"),
               "storage": dict(FEMO_OP_STORAGE="f32"),
               "storage_lane": dict(FEMO_OP_STORAGE="f32",
                                    FEMO_LANE_MAJOR="1")}


def passes_only(nx, ny):
    """Every plate case's passes, as one JSON line (the pinned runs)."""
    out = {name: plate(nx, ny, **env)["passes"].tolist()
           for name, env in PLATE_CASES.items()}
    print("PASSES " + json.dumps(out), flush=True)


def _pinned(nx, ny, cores):
    """passes_only in a process pinned to the first `cores` cores."""
    run = subprocess.run(
        ["taskset", "-c", f"0-{cores - 1}", sys.executable,
         os.path.abspath(__file__), "passes", str(nx), str(ny)],
        capture_output=True, text=True, check=True)
    line = [ln for ln in run.stdout.splitlines() if ln.startswith("PASSES")]
    return json.loads(line[-1][len("PASSES "):])


# --------------------------------------------------------------- the band
def band(n_chord, n_span, ribs, th, E, nu, seed_th=None):
    """BandCholPrecond(dtype=float32) as CG's preconditioner on a penalty
    wing's assembled system (tests/test_band.py::test_band_f32_precond_cg):
    x, iterations, converged, the true relative residual, and whether the
    unshifted f32 factor was finite."""
    from femo_alpha_tpu.assembly.assemble import element_matrices, make_matvec
    from femo_alpha_tpu.mesh import createWingShellMesh
    from femo_alpha_tpu.models.rm_shell.pde import RMShellPDE
    from femo_alpha_tpu.solvers import band as B

    m = createWingShellMesh(n_chord=n_chord, n_span=n_span,
                            rib_stations=ribs)
    pde = RMShellPDE(m, element_wise_material=True)
    W, n, nel = pde.W, pde.W.n_dofs, m.n_cells
    ff = pde.make_penalty_facet_form(lambda x: np.abs(x[:, 1]) < 1e-9)
    thv = np.full(nel, th)
    if seed_th is not None:
        thv = th * (1.0 + 0.2 * np.random.default_rng(seed_th).uniform(
            size=nel))
    params = {"thickness": jnp.asarray(thv), "E": jnp.full(nel, E),
              "nu": jnp.full(nel, nu), "uhat": jnp.zeros(3 * m.n_nodes),
              "F_solid": jnp.zeros(3 * m.n_nodes)}
    u0 = jnp.zeros(n)
    ops = [(element_matrices(pde.make_residual_form(), u0, params), W)]
    ops += ff.element_ops(u0, params)
    dofmaps = [B._dofmap_of(W)] + [np.asarray(dm) for _, dm in ops[1:]]
    mvs = [make_matvec(Ae, sp if hasattr(sp, "gather") else jnp.asarray(sp),
                       n_dofs=n) for Ae, sp in ops]

    def A(x):
        y = mvs[0](x)
        for f in mvs[1:]:
            y = y + f(x)
        return y

    bc = B.BandCholPrecond(W, dofmaps, dtype=jnp.float32)
    t0 = time.perf_counter()
    state = bc.setup(ops)
    jax.block_until_ready(state)
    setup_s = time.perf_counter() - t0
    # the guard: was the unshifted f32 factor finite?
    R = B.assemble_block_band(bc.permute_ops(ops), n, bc.w, bc.m,
                              dtype=jnp.float64)
    Rs, _ = B.equilibrate(R, bc.w, bc.m)
    Ld, Lc = B.band_cholesky(Rs.astype(jnp.float32), bc.w, bc.m)
    finite = bool(jnp.isfinite(jnp.sum(Ld) + jnp.sum(Lc)))
    b = jnp.asarray(np.random.default_rng(1).standard_normal(n))
    SOLVES.clear()
    x, info = krylov.cg_solve(A, b, M=lambda v: bc.apply(state, v),
                              tol=1e-8, maxiter=60)
    x = np.asarray(jax.block_until_ready(x))
    jax.effects_barrier()
    rel = float(jnp.linalg.norm(A(jnp.asarray(x)) - b) / jnp.linalg.norm(b))
    return dict(x=x, iters=int(info["iters"]),
                converged=bool(info["converged"]), rel=rel,
                unshifted_finite=finite, n_dofs=n, b_half=bc.b, w=bc.w,
                setup_s=setup_s)


# ---------------------------------------------------------------- the AMG
def amg():
    """The 10x24 wing (tests/test_amg.py's forced-guard case) on the
    model's AMGPrecondFactory with dtype=float32."""
    from femo_alpha_tpu.mesh import createWingShellMesh
    from femo_alpha_tpu.models import RMShellModel

    _flags(FEMO_BAND_MEM_GB="0.000001")
    try:
        mesh = createWingShellMesh(n_chord=10, n_span=24, rib_stations=(12,),
                                   shuffle_seed=3)
        model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 1] < 1e-9,
                             element_wise_material=True)
    finally:
        _flags()
    pc = model.fea.states["disp_solid"].pde._pc
    assert type(pc).__name__ == "AMGPrecondFactory", type(pc)
    pc.dtype = jnp.float32
    nel, nn = mesh.n_cells, mesh.n_nodes
    f = jnp.zeros(3 * nn).at[2::3].set(200.0)
    E, nu, rho = jnp.full(nel, 4.32e8), jnp.zeros(nel), jnp.full(nel, 100.0)

    def J(th):
        out = model.evaluate(f, th, E, nu, rho, is_pressure=True)
        return jnp.reshape(out.compliance, ()), out.disp_solid

    SOLVES.clear()
    (val, u), g = jax.value_and_grad(J, has_aux=True)(jnp.full(nel, 0.2))
    g = np.asarray(jax.block_until_ready(g))
    jax.effects_barrier()
    return dict(J=float(val), grad=g, u=np.asarray(u),
                iters=np.asarray([sum(s["passes"]) for s in SOLVES]),
                passes=np.asarray([s["passes"] for s in SOLVES]),
                n_dofs=model.shell_pde.W.n_dofs)


def amg_parts():
    """AggregationAMG on the 6x8 wing of tests/test_torch_amg.py (its
    element matrices at thickness 0.01, E 7e10, nu 0.33; the root clamped
    by the free mask) set up in f32 and in f64: lmax and one apply of each
    (in f64) to a seeded vector."""
    from femo_alpha_tpu.spaces import locate_dofs_geometric
    from femo_alpha_tpu.assembly.assemble import element_matrices
    from femo_alpha_tpu.mesh import createWingShellMesh
    from femo_alpha_tpu.models.rm_shell.pde import RMShellPDE
    from femo_alpha_tpu.solvers.amg import AggregationAMG

    m = createWingShellMesh(n_chord=6, n_span=8, rib_stations=(4,))
    pde = RMShellPDE(m, element_wise_material=True)
    n, nel = pde.W.n_dofs, m.n_cells
    p = {"thickness": jnp.full(nel, 0.01), "E": jnp.full(nel, 7e10),
         "nu": jnp.full(nel, 0.33), "uhat": jnp.zeros(3 * m.n_nodes),
         "F_solid": jnp.zeros(3 * m.n_nodes)}
    Ae = element_matrices(pde.make_residual_form(), jnp.zeros(n), p)
    def root(x):
        return np.abs(x[:, 1]) < 1e-9

    free = np.ones(n)
    free[locate_dofs_geometric(pde.V_disp, root)] = 0.0
    free[locate_dofs_geometric(pde.V_rot, root) + pde.V_disp.n_dofs] = 0.0
    amg_ = AggregationAMG(pde.W)
    b = jnp.asarray(np.random.default_rng(7).standard_normal(n))
    out = {"free": free}
    for tag, dt in (("32", jnp.float32), ("64", None)):
        st = amg_.setup(Ae, free_mask=jnp.asarray(free), dtype=dt)
        out[f"lmax{tag}"] = np.asarray(st["lmax"])
        out[f"y{tag}"] = np.asarray(amg_.apply(st, b))
    out["b"] = np.asarray(b)
    return out


# ----------------------------------------------------------- the PlateSim
def sim(nx, ny, nsteps, coarsest):
    """PlateSim with the f32 step MG (see the module docstring)."""
    from femo_alpha_tpu.mesh import createRectangleMesh
    from femo_alpha_tpu.models.dynamic_rm_shell import PlateSim
    from femo_alpha_tpu.models.dynamic_rm_shell import mg as dmg
    from femo_alpha_tpu.models.dynamic_rm_shell import plate_sim as ps
    from femo_alpha_tpu_torch.benchmarks import gust_history

    ps.cg_solve = _cg_recording
    mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad", gdim=3)
    s = PlateSim(mesh, E=4.32e8, nu=0.0, rho=100.0, dt=0.01, Nsteps=nsteps,
                 element_wise_thickness=True, solver_method="mg",
                 mg_coarsest_cells=coarsest)
    s.mg = dmg.build_platesim_mg(s, coarsest_cells=coarsest,
                                 dtype=jnp.float32)
    fh = jnp.asarray(gust_history(mesh.n_nodes, nsteps, s.dt))

    def total_energy(h):
        return jnp.sum(s.strain_energy_history(s.simulate(h, fh), h))

    SOLVES.clear()
    e, g = jax.value_and_grad(total_energy)(jnp.full(s.num_var, 0.1))
    g = np.asarray(jax.block_until_ready(g))
    jax.effects_barrier()
    iters = [sum(v["passes"]) for v in SOLVES]
    return dict(energy=float(e), grad=g, iters=np.asarray(iters),
                levels=len(s.mg.levels), n_dofs=s.fe_dofs)


# ---------------------------------------------------- the affine operator
def affine():
    """AffineDesignOperator (cell-major, f64 basis) on the 4x2 plate: its
    matvec and its astype(float32).matvec at a seeded design and vector."""
    from femo_alpha_tpu.assembly.affine import AffineDesignOperator
    from femo_alpha_tpu.mesh import createRectangleMesh
    from femo_alpha_tpu.models.rm_shell.pde import RMShellPDE

    mesh = createRectangleMesh(4, 2, (0, 0), (10.0, 2.0), "quad", gdim=3)
    pde = RMShellPDE(mesh, element_wise_material=True)
    nel, nn, n = mesh.n_cells, mesh.n_nodes, pde.W.n_dofs
    rng = np.random.default_rng(11)
    others = {"E": jnp.full(nel, 4.32e8), "nu": jnp.full(nel, 0.3),
              "uhat": jnp.zeros(3 * nn), "F_solid": jnp.zeros(3 * nn)}
    aff = AffineDesignOperator(
        pde.make_residual_form(), np.zeros(n),
        lambda th: {**others, "thickness": th}, probe_scale=0.2)
    th = jnp.asarray(0.2 * (1.0 + 0.3 * rng.uniform(size=nel)))
    x = jnp.asarray(rng.standard_normal(n))
    y64 = aff.matvec(th, pde.W, x)
    a32 = aff.astype(jnp.float32)
    return dict(theta=np.asarray(th), x=np.asarray(x),
                y64=np.asarray(y64),
                y32=np.asarray(a32.matvec(th, pde.W, x)),
                y32_f32=np.asarray(a32.matvec(th.astype(jnp.float32),
                                              pde.W,
                                              x.astype(jnp.float32))),
                basis32=np.asarray(a32.basis))


# ------------------------------------------------------------------ parts
def tests(cases=()):
    """All cases, or only `cases` (the others kept from the npz)."""
    t0 = time.perf_counter()
    out = {}
    if cases:
        with np.load(TESTS_NPZ) as z:
            out = {k: z[k] for k in z.files}
    every = ("plates", "f64", "band", "amg", "amg6", "sim", "affine")

    def want(c):
        return c in (cases or every)

    spans = ({c: _pinned(64, 16, c) for c in (1, 4)} if want("plates")
             else {})
    for name, env in (PLATE_CASES.items() if want("plates") else ()):
        r = plate(64, 16, **env)
        say("tests", case=name, n_dofs=r["n_dofs"], levels=r["levels"],
            mg_dtype=r["mg_dtype"], J=f"{r['J']:.15e}",
            passes=r["passes"].tolist(), converged=r["converged"].tolist(),
            rel=[f"{v:.3e}" for v in r["rel"]],
            passes_1=spans[1][name], passes_4=spans[4][name])
        for k in ("J", "grad", "u", "passes", "converged", "rel"):
            out[f"{name}_{k}"] = np.asarray(r[k])
        out[f"{name}_passes_1"] = np.asarray(spans[1][name])
        out[f"{name}_passes_4"] = np.asarray(spans[4][name])
    if want("f64"):
        r = plate(64, 16)
        say("tests", case="f64", J=f"{r['J']:.15e}",
            passes=r["passes"].tolist())
        for k in ("J", "grad", "u", "passes"):
            out[f"f64_{k}"] = np.asarray(r[k])
    if want("band"):
        r = band(8, 36, (18,), 0.02, 7e10, 0.33, seed_th=4)
        say("tests", case="band", n_dofs=r["n_dofs"], iters=r["iters"],
            converged=r["converged"], rel=f"{r['rel']:.3e}",
            unshifted_finite=r["unshifted_finite"])
        for k in ("x", "iters", "converged", "rel", "unshifted_finite"):
            out[f"band_{k}"] = np.asarray(r[k])
    if want("amg"):
        r = amg()
        say("tests", case="amg", J=f"{r['J']:.15e}",
            grad_norm=f"{np.linalg.norm(r['grad']):.15e}",
            iters=r["iters"].tolist(), passes=r["passes"].tolist())
        for k in ("J", "grad", "u", "iters"):
            out[f"amg_{k}"] = np.asarray(r[k])
    if want("amg6"):
        r = amg_parts()
        say("tests", case="amg6", lmax32=float(r["lmax32"]),
            lmax64=float(r["lmax64"]),
            y32_vs_y64=f"{np.linalg.norm(r['y32'] - r['y64']) / np.linalg.norm(r['y64']):.3e}")
        out.update({f"amg6_{k}": v for k, v in r.items()})
    if want("sim"):
        r = sim(16, 8, 4, 16)
        say("tests", case="sim", levels=r["levels"], n_dofs=r["n_dofs"],
            energy=f"{r['energy']:.15e}",
            grad_norm=f"{np.linalg.norm(r['grad']):.15e}",
            iters=r["iters"].tolist())
        for k in ("energy", "grad", "iters"):
            out[f"sim_{k}"] = np.asarray(r[k])
    if want("affine"):
        out.update({f"affine_{k}": v for k, v in affine().items()})
    np.savez_compressed(TESTS_NPZ, **out)
    print(f"wrote {os.path.relpath(TESTS_NPZ, ROOT)} ({len(out)} arrays) "
          f"in {time.perf_counter() - t0:.1f} s")


def chip():
    r = plate(128, 32)
    say("chip", case="f64", J=f"{r['J']:.15e}",
        grad_norm=f"{np.linalg.norm(r['grad']):.15e}",
        passes=r["passes"].tolist())
    spans = {c: _pinned(128, 32, c) for c in (1, 4)}
    for name, env in PLATE_CASES.items():
        r = plate(128, 32, **env)
        say("chip", case=name, n_dofs=r["n_dofs"], levels=r["levels"],
            mg_dtype=r["mg_dtype"], J=f"{r['J']:.15e}",
            grad_norm=f"{np.linalg.norm(r['grad']):.15e}",
            tip=f"{float(np.max(np.abs(r['u']))):.15e}",
            passes=r["passes"].tolist(), passes_1=spans[1][name],
            passes_4=spans[4][name], converged=r["converged"].tolist(),
            rel=[f"{v:.3e}" for v in r["rel"]],
            wall_s=f"{r['wall_s']:.1f}")
    r = band(18, 66, (22, 44), 0.006, 69e9, 0.33)
    say("chip", case="band", n_dofs=r["n_dofs"], b=r["b_half"], w=r["w"],
        iters=r["iters"], converged=r["converged"], rel=f"{r['rel']:.3e}",
        unshifted_finite=r["unshifted_finite"],
        x_norm=f"{np.linalg.norm(r['x']):.15e}",
        x_sum=f"{np.sum(r['x']):.15e}")
    r = amg()
    say("chip", case="amg", J=f"{r['J']:.15e}",
        grad_norm=f"{np.linalg.norm(r['grad']):.15e}",
        iters=r["iters"].tolist())
    r = sim(40, 20, 5, 64)
    say("chip", case="sim", levels=r["levels"], n_dofs=r["n_dofs"],
        energy=f"{r['energy']:.15e}",
        grad_norm=f"{np.linalg.norm(r['grad']):.15e}",
        grad_sum=f"{np.sum(r['grad']):.15e}", iters=r["iters"].tolist())


def amg_span():
    """The f32 AMG's CG iterations from processes pinned to 1 and to 4
    cores (the JAX runs' own span; the chip part's run is the third)."""
    for cores in (1, 4):
        run = subprocess.run(
            ["taskset", "-c", f"0-{cores - 1}", sys.executable,
             os.path.abspath(__file__), "amg-iters"],
            capture_output=True, text=True, check=True)
        line = [ln for ln in run.stdout.splitlines()
                if ln.startswith("ITERS")][-1]
        say("amg_span", cores=cores, iters=line[len("ITERS "):])


def main():
    part = sys.argv[1] if len(sys.argv) > 1 else "tests"
    if part == "passes":
        return passes_only(int(sys.argv[2]), int(sys.argv[3]))
    if part == "amg-iters":
        print("ITERS " + json.dumps(amg()["iters"].tolist()), flush=True)
        return None
    if part == "amg-span":
        return amg_span()
    if part == "tests":
        return tests(tuple(sys.argv[2:]))
    {"chip": chip}[part]()


if __name__ == "__main__":
    main()
