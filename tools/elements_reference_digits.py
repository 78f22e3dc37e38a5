"""The JAX package's digits for the CG1CG1 and CG2CR1 shell elements: the
constants ELEMENTS_DIGITS / ELEMENTS_PASSES of chip_smoke.py's
`elements_cg1` and `elements_cr` phases, and
tests/reference_digits/elements.npz, the reference side of
tests/test_torch_elements.py's pinned cases:

    FEMO_PLATFORM=cpu python tools/elements_reference_digits.py [tests|cg1|cg1-one-core|cr|spread]

The script runs the JAX package on the CPU in f64 with FEMO_SETUP_CACHE=0
and FEMO_COMPILE_CACHE=0 (it sets both itself) and its FEMO_* solver flags
unset (FEMO_MG_F32, FEMO_LANE_MAJOR, FEMO_HOSTLOOP, FEMO_CG_DF,
FEMO_OP_STORAGE, FEMO_BAND_MEM_GB). The setup cache must stay off: its
affine-basis key (femo_alpha_tpu/assembly/affine.py::_disk_key) leaves out
the form's quadrature degrees, so a CG1CG1 model with reduced shear would
reload the basis a fully integrated model stored before it and return the
locked plate's tip. Krylov iterations are read from inside the jitted
solves by a debug callback, per CG pass (the first and the restart from
the true residual), on a copy of the JAX package's krylov.cg_solve, step
for step. The configurations are femo_alpha_tpu_torch.benchmarks.
ELEMENT_PLATES and element_inputs (numpy), handed to the JAX package's
createRectangleMesh and RMShellModel.

- tests (~6 min on 8 cores): each element variant (CG2CR1 on triangles,
  CG1CG1 with full and with reduced integration) on the 4x2 plate at
  seeded inputs (form_inputs): its cell and penalty facet element
  matrices, residual, output forms and DG1 stress projection, and the
  dense eigenvalues of the 8x4 plate; the reference's own element tests on the
  20x4 plate 10 x 2 (penalty BCs, the dense route; f_z = 10 h = 2,
  h = 0.2, E = 4.32e8, nu = 0, rho = 1 per cell): CG2CR1 on triangles
  (cr20), CG1CG1 fully integrated (cg1_20_locked) and with inplane_deg 2,
  shear_deg 1 (cg1_20_fixed); then one plate on each other route at
  element_inputs' design 1: elements_cg1 at 64x16 (6,630 dofs, MG on two
  levels, cg1_mg64), the same CG1CG1 plate with penalty BCs (the band
  route, cg1_band64) and with the band guard forced low
  (FEMO_BAND_MEM_GB=0.000001: the aggregation AMG, cg1_amg64), and
  elements_cr at 40x8 (7,155 dofs, the band route, cr_band40). Each: the
  state, the compliance, the mass, the tip (max u), dJ/dh per cell and
  the CG iterations of each pass of the forward and adjoint solves (from
  zero); the route cases' passes once more in a process pinned to one
  core (the restart pass follows rounding). Written to
  tests/reference_digits/elements.npz.
- cg1 / cr: elements_cg1 (256x64, 100,230 dofs, MG on 4 levels) and
  elements_cr (128x32, 87,459 dofs; the band guard's estimate and the
  preconditioner the reference selects) at design 0 and design 1, each
  from zero: the compliance, |dJ/dh| (2-norm), sum(dJ/dh), the mass, the
  tip and the CG iterations per pass (~3 min each on 8 cores);
  cg1-one-core runs cg1 again in a process pinned to one core (its CG
  passes follow rounding, which the thread count changes).
- spread (~5 min on 8 cores): the JAX package's own solve-to-solve
  spread on the route cases, the run on 8 threads against the same run
  pinned to one core, and on the band cases against the same plate solved
  densely (solver_opts={"method": "dense"}): the relative difference of
  the state (max norm), the compliance, the mass and |dJ/dh|. It is what
  the test's bars on the penalty routes are set from.
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

for _flag in ("FEMO_MG_F32", "FEMO_LANE_MAJOR", "FEMO_HOSTLOOP", "FEMO_CG_DF",
              "FEMO_OP_STORAGE", "FEMO_BAND_MEM_GB"):
    os.environ.pop(_flag, None)
os.environ["FEMO_SETUP_CACHE"] = "0"
os.environ["FEMO_COMPILE_CACHE"] = "0"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import femo_alpha_tpu  # noqa: E402,F401  (platform and x64 configuration)
from femo_alpha_tpu.mesh import createRectangleMesh  # noqa: E402
from femo_alpha_tpu.models import RMShellModel  # noqa: E402
from femo_alpha_tpu.solvers import krylov, linear  # noqa: E402
from femo_alpha_tpu_torch.benchmarks import (  # noqa: E402
    ELEMENT_PLATES,
    element_inputs,
)

TESTS_NPZ = os.path.join(ROOT, "tests", "reference_digits", "elements.npz")
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


def plate(name, nx=None, ny=None, designs=(1,), guard=None, rho=None,
          f_z=None, **override):
    """The JAX model of ELEMENT_PLATES[name] (keywords replaced by
    `override`) at element_inputs' designs, each evaluate + value_and_grad
    of the compliance from zero. Returns the model's facts and one dict of
    results per design."""
    (nx0, ny0, cell), kw = ELEMENT_PLATES[name]
    kw = {**kw, **override}
    mesh = createRectangleMesh(nx or nx0, ny or ny0, (0, 0), (10.0, 2.0),
                               cell, gdim=3)
    if guard is not None:
        os.environ["FEMO_BAND_MEM_GB"] = guard
    try:
        t0 = time.perf_counter()
        model = RMShellModel(mesh, shell_bc_func=_bc,
                             element_wise_material=True, **kw)
        setup_s = time.perf_counter() - t0
    finally:
        os.environ.pop("FEMO_BAND_MEM_GB", None)
    spde = model.fea.states["disp_solid"].pde
    facts = dict(n_dofs=model.shell_pde.W.n_dofs,
                 precond=type(spde._pc).__name__ if spde._pc is not None
                 else spde.solver_opts.get("method", "none"),
                 setup_s=setup_s)
    results = []
    for design in designs:
        f, th, E, nu, rho_ = element_inputs(mesh, design)
        if rho is not None:
            rho_ = np.full_like(rho_, rho)
        if f_z is not None:
            f[:, 2] = f_z
        mat = dict(E=jnp.asarray(E), nu=jnp.asarray(nu),
                   density=jnp.asarray(rho_))
        model.model._last_states = {}

        def J(h):
            return jnp.reshape(model.evaluate(jnp.asarray(f), h,
                                              **mat).compliance, ())

        PASSES.clear()
        t0 = time.perf_counter()
        val, g = jax.value_and_grad(J)(jnp.asarray(th))
        g = np.asarray(jax.block_until_ready(g))
        jax.effects_barrier()
        wall = time.perf_counter() - t0
        passes = [PASSES[i:i + 2] for i in range(0, len(PASSES), 2)]
        # the state and the mass: one more forward solve from zero
        model.model._last_states = {}
        out = model.evaluate(jnp.asarray(f), jnp.asarray(th), **mat)
        u = np.asarray(out.disp_solid)
        results.append(dict(
            compliance=float(val), mass=float(out.mass),
            tip=float(u.max()), grad=g, u=u,
            grad_norm=float(np.linalg.norm(g)), grad_sum=float(np.sum(g)),
            cg_passes=np.asarray(passes, dtype=np.int64).reshape(-1, 2),
            wall_s=wall))
    return facts, results


# (key, ELEMENT_PLATES name, nx, ny, keywords of `plate`)
TEST_CASES = (
    ("cr20", "elements_cr", 20, 4, dict(designs=(0,), rho=1.0)),
    ("cg1_20_locked", "elements_cg1", 20, 4,
     dict(designs=(0,), rho=1.0, PENALTY_BC=True, inplane_deg=4,
          shear_deg=4)),
    ("cg1_20_fixed", "elements_cg1", 20, 4,
     dict(designs=(0,), rho=1.0, PENALTY_BC=True)),
    ("cg1_mg64", "elements_cg1", 64, 16, {}),
    ("cg1_band64", "elements_cg1", 64, 16, dict(PENALTY_BC=True)),
    ("cg1_amg64", "elements_cg1", 64, 16,
     dict(PENALTY_BC=True, guard="0.000001")),
    ("cr_band40", "elements_cr", 40, 8, {}),
)


# (key, cell type, element_type, inplane_deg, shear_deg) of the form-level
# and modal cases
FORM_CASES = (("cr", "triangle", "CG2CR1", 4, 4),
              ("cg1", "quad", "CG1CG1", 4, 4),
              ("cg1r", "quad", "CG1CG1", 2, 1))


def form_inputs(n_cells, n_nodes, n_dofs):
    """Seeded inputs of the form-level cases (numpy; the test makes the
    same ones): thickness, E, nu, rho per cell, a small uhat, the f_z = 2
    load and a state u."""
    rng = np.random.default_rng(5)
    th = 0.2 * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, n_cells))
    E = 4.32e8 * (1.0 + 0.1 * rng.uniform(-1.0, 1.0, n_cells))
    nu = 0.3 + 0.02 * rng.uniform(-1.0, 1.0, n_cells)
    rho = 100.0 * (1.0 + 0.1 * rng.uniform(-1.0, 1.0, n_cells))
    uhat = 1e-2 * rng.standard_normal(3 * n_nodes)
    f = np.zeros(3 * n_nodes)
    f[2::3] = 2.0
    u = 1e-3 * rng.standard_normal(n_dofs)
    return th, E, nu, rho, uhat, f, u


def forms():
    """Per element variant on the 4x2 plate 10 x 2 at form_inputs: the
    cell element matrices (zero state), the penalty facet form's (the clamp
    at x = 0, in its groups' order), the residual at u, and at u the
    compliance, mass, volume, elastic energy, p-norm stress and the DG1
    von Mises projection."""
    from femo_alpha_tpu.assembly.assemble import (
        assemble_residual,
        assemble_scalar,
        element_matrices,
    )
    from femo_alpha_tpu.models.rm_shell.pde import RMShellPDE

    out = {}
    for key, cell, et, ideg, sdeg in FORM_CASES:
        mesh = createRectangleMesh(4, 2, (0, 0), (10.0, 2.0), cell, gdim=3)
        pde = RMShellPDE(mesh, element_wise_material=True, element_type=et,
                         inplane_deg=ideg, shear_deg=sdeg)
        n = pde.W.n_dofs
        th, E, nu, rho, uhat, f, u = (
            jnp.asarray(a) for a in form_inputs(mesh.n_cells, mesh.n_nodes,
                                                n))
        p = {"thickness": th, "E": E, "nu": nu, "uhat": uhat, "F_solid": f}
        q = {k: v for k, v in p.items() if k != "F_solid"}
        zero = jnp.zeros(n)
        out[f"form_{key}_Ae"] = np.asarray(element_matrices(
            pde.make_residual_form(), zero, p))
        ops = pde.make_penalty_facet_form(_bc).element_ops(
            zero, {"uhat": uhat})
        out[f"form_{key}_facet_Ae"] = np.concatenate(
            [np.asarray(Ae) for Ae, _ in ops])
        out[f"form_{key}_residual"] = np.asarray(assemble_residual(
            pde.make_residual_form(), u, p))
        scal = {
            "compliance": (pde.compliance_form(), u,
                           {"thickness": th, "uhat": uhat}),
            "mass": (pde.mass_form(), th, {"density": rho, "uhat": uhat}),
            "volume": (pde.volume_form(), th, {"uhat": uhat}),
            "elastic_energy": (pde.elastic_energy_form(), u, q),
            "pnorm_stress": (pde.pnorm_stress_form(), u, q),
        }
        for name, (form, arg, prm) in scal.items():
            val = float(assemble_scalar(form, arg, prm))
            out[f"form_{key}_{name}"] = np.asarray(val)
            say(f"form_{key}", name, f"{val:.15e}")
        project, _ = pde.von_mises_dg1_projection()
        out[f"form_{key}_stress_dg1"] = np.asarray(project(u, q))
        say(f"form_{key}", "Ae_shape", out[f"form_{key}_Ae"].shape)
    return out


def modal():
    """evaluate_modal(n_modes=4, solver="dense") of the 8x4 plate 2 x 1
    per element variant, strong clamp at x = 0, element-wise h = 0.02,
    E = 7e10, nu = 0.3, rho = 2,700: the eigenvalues."""
    out = {}
    for key, cell, et, ideg, sdeg in FORM_CASES:
        mesh = createRectangleMesh(8, 4, (0, 0), (2.0, 1.0), cell, gdim=3)
        model = RMShellModel(mesh, shell_bc_func=_bc,
                             element_wise_material=True, PENALTY_BC=False,
                             element_type=et, inplane_deg=ideg,
                             shear_deg=sdeg)
        nel = mesh.n_cells
        lam = model.evaluate_modal(np.full(nel, 0.02), np.full(nel, 7.0e10),
                                   np.full(nel, 0.3), np.full(nel, 2700.0),
                                   n_modes=4, solver="dense").eigenvalues
        out[f"modal_{key}_eigenvalues"] = np.asarray(lam)
        say(f"modal_{key}", "eigenvalues", np.asarray(lam).tolist())
    return out


ROUTE_CASES = ("cg1_mg64", "cg1_band64", "cg1_amg64", "cr_band40")


def passes_one_core():
    """The route cases alone, in a process pinned to one core (`taskset -c
    0`): the restart pass starts at the f64 evaluation floor of the
    residual, so its length follows rounding, which the thread count
    changes. Prints one JSON line: per case the CG passes, the state, the
    compliance, the mass and |dJ/dh|."""
    got = {}
    for key, name, nx, ny, kw in TEST_CASES:
        if key in ROUTE_CASES:
            r = plate(name, nx, ny, **kw)[1][0]
            got[key] = {"cg_passes": r["cg_passes"].tolist(),
                        "u": r["u"].tolist(),
                        **{k: r[k] for k in ("compliance", "mass",
                                             "grad_norm")}}
    print("PASSES_JSON " + json.dumps(got), flush=True)


def _one_core():
    """passes_one_core's results, from a process pinned to one core."""
    one = subprocess.run(
        ["taskset", "-c", "0", sys.executable, os.path.abspath(__file__),
         "passes-one-core"], check=True, capture_output=True, text=True)
    line = [ln for ln in one.stdout.splitlines()
            if ln.startswith("PASSES_JSON ")][-1]
    return json.loads(line[len("PASSES_JSON "):])


def spread():
    """The route cases on 8 threads against the same cases on one core,
    and the band cases against a dense solve of the same plate."""
    one_core = _one_core()
    for key, name, nx, ny, kw in TEST_CASES:
        if key not in ROUTE_CASES:
            continue
        facts, (r,) = plate(name, nx, ny, **kw)
        others = {"one_core": one_core[key]}
        if facts["precond"] == "BandPrecond":
            others["dense"] = plate(name, nx, ny,
                                    solver_opts={"method": "dense"},
                                    **kw)[1][0]
        for label, o in others.items():
            u = np.asarray(o["u"])
            say(key, f"{label}_u_rel",
                f"{np.abs(r['u'] - u).max() / np.abs(u).max():.3e}")
            for k in ("compliance", "mass", "grad_norm"):
                say(key, f"{label}_{k}_rel", f"{abs(r[k] / o[k] - 1.0):.3e}")
        say(key, "cg_passes", f"{r['cg_passes'].tolist()} on 8 threads, "
            f"{one_core[key]['cg_passes']} on one core")


def tests():
    one_core = {k: v["cg_passes"] for k, v in _one_core().items()}
    out = {**forms(), **modal()}
    for key, v in one_core.items():
        say(key, "cg_passes_one_core", v)
        out[f"{key}_cg_passes_one_core"] = np.asarray(v, dtype=np.int64)
    for key, name, nx, ny, kw in TEST_CASES:
        facts, (r,) = plate(name, nx, ny, **kw)
        for k, v in facts.items():
            say(key, k, v)
        for k, v in r.items():
            if np.ndim(v) == 0:
                say(key, k, f"{v:.15e}" if isinstance(v, float) else v)
            elif k == "cg_passes":
                say(key, k, v.tolist())
            if k != "wall_s":
                out[f"{key}_{k}"] = np.asarray(v)
        out[f"{key}_n_dofs"] = np.asarray(facts["n_dofs"])
        out[f"{key}_precond"] = np.asarray(facts["precond"])
    np.savez_compressed(TESTS_NPZ, **out)
    say("tests", "wrote", os.path.relpath(TESTS_NPZ, ROOT))


def chip(part):
    name = {"cg1": "elements_cg1", "cr": "elements_cr"}[part]
    facts, results = plate(name, designs=(0, 1))
    for k, v in facts.items():
        say(part, k, v)
    if part == "cr":
        # the reference's band memory guard on this plate
        from femo_alpha_tpu.models.rm_shell.pde import RMShellPDE
        from femo_alpha_tpu.solvers.band import band_precond_factory

        (nx, ny, cell), kw = ELEMENT_PLATES[name]
        mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), cell, gdim=3)
        pde = RMShellPDE(mesh, element_wise_material=True,
                         element_type=kw["element_type"])
        b = band_precond_factory(
            pde.W, pde.make_residual_form(),
            [pde.make_penalty_facet_form(_bc)]).band
        say(part, "band_estimate_gb",
            f"{b.n_pad * (b.m + 1) * b.w * 12 / 1e9:.4f}")
    for design, r in zip((0, 1), results):
        for k in ("compliance", "grad_norm", "grad_sum", "mass", "tip"):
            say(part, f"design{design}_{k}", f"{r[k]:.15e}")
        say(part, f"design{design}_cg_passes", r["cg_passes"].tolist())
        say(part, f"design{design}_wall_s", f"{r['wall_s']:.1f}")


def main():
    part = sys.argv[1] if len(sys.argv) > 1 else "tests"
    t0 = time.perf_counter()
    if part == "tests":
        tests()
    elif part in ("cg1", "cr"):
        chip(part)
    elif part == "cg1-one-core":
        # the same run pinned to one core, in a process of its own (XLA
        # sizes its thread pool at start-up)
        subprocess.run(["taskset", "-c", "0", sys.executable,
                        os.path.abspath(__file__), "cg1"], check=True)
    elif part == "passes-one-core":
        passes_one_core()
    elif part == "spread":
        spread()
    else:
        raise SystemExit(f"part {part!r}: tests, cg1, cg1-one-core, cr or "
                         "spread")
    say(part, "seconds", f"{time.perf_counter() - t0:.1f}")


if __name__ == "__main__":
    main()
