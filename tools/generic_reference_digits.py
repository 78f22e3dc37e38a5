"""The JAX package's digits at the inputs of chip_smoke.py's `poisson`,
`nonlinear`, `elasticity` and `beam` phases (POISSON_DIGITS,
NONLINEAR_DIGITS, ELASTICITY_DIGITS, BEAM_DIGITS there):

    FEMO_PLATFORM=cpu FEMO_COMPILE_CACHE=0 python tools/generic_reference_digits.py [PART ...]

PART is one of poisson, nonlinear, elasticity, elasticity160, beam (all by
default). The JAX package runs on the CPU in f64 with its FEMO_* solver
flags unset (the script unsets them). Each linear solve is the one the
model's ImplicitPDE makes (`pde.make_solver(0, params).solve(r(0))`, the
JAX package's LinearSolver with its default point-Jacobi CG at the model's
tolerance), so its CG iteration count can be read; every solve of the
phases' models starts from zero.

- poisson: PoissonModel P1 on createUnitSquareMesh(1024, 1024, "triangle")
  (1,050,625 dofs, 2,097,152 cells), kappa DG0 1 + 0.5 U[0,1) from
  default_rng(0), f = 2 pi^2 sin(pi x) sin(pi y) at the dofs: compliance
  f.u, max |u - sin(pi x) sin(pi y)|, the CG iterations, and the JAX
  solution's distance from a host SuperLU solve of the same assembled
  constrained system (relative 2-norm).
- nonlinear: NonlinearPoissonModel P1 on createUnitSquareMesh(512, 512),
  newton_iters=8, kappa and f as tests/test_nonlinear.py::_params (scale
  40, default_rng(3)): solve_checked's Newton iterations and residual, the
  fixed-trip evaluate's compliance, residual and distance from the checked
  state.
- elasticity / elasticity160: ElasticityModel Q2 on
  createRectangleMesh(320, 32 / 160, 16, (0, 0), (10, 1), "quad"),
  E = 1e6, nu = 0, t = 1, the load density f_y = -1 at the vertices (as
  tests/test_models_basic.py::test_elasticity_cantilever_physics_and_adjoint):
  compliance, volume, tip |u_y|, the CG iterations and the distance from a
  host SuperLU solve.
- beam: the SLSQP study of
  examples/basic_examples/beam_thickness_opt at nel = 50 (maxiter 1000,
  ftol 1e-9): the optimum, nit / nfev / njev and the scipy version (the
  trajectory depends on it).
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

import jax.numpy as jnp  # noqa: E402
import scipy  # noqa: E402
import scipy.sparse as sp  # noqa: E402
from scipy.sparse.linalg import splu  # noqa: E402

from femo_alpha_tpu.mesh import (  # noqa: E402
    createRectangleMesh,
    createUnitSquareMesh,
)
from femo_alpha_tpu.models import (  # noqa: E402
    ElasticityModel,
    EulerBernoulliBeamModel,
    NonlinearPoissonModel,
    PoissonModel,
)
from femo_alpha_tpu.opt import OptimizationProblem  # noqa: E402


def say(part, **kv):
    for k, v in kv.items():
        if isinstance(v, float):
            v = f"{v:.15e}"
        print(f"[{part}] {k} {v}", flush=True)


def direct_solve(solver, b):
    """Host SuperLU solve of the JAX LinearSolver's assembled constrained
    matrix f*A*f + (1-f)*I (its one cell block)."""
    Ae = np.asarray(solver.ops[0][0])
    dm = np.asarray(solver.ops[0][1].dofmap)
    nc, nd, _ = Ae.shape
    n = solver.n
    rows = np.repeat(dm, nd, axis=1).ravel()
    cols = np.tile(dm, (1, nd)).ravel()
    A = sp.csr_matrix((Ae.ravel(), (rows, cols)), shape=(n, n))
    f = np.asarray(solver.free_mask)
    A = sp.diags(f) @ A @ sp.diags(f) + sp.diags(1.0 - f)
    return splu(A.tocsc(), permc_spec="MMD_AT_PLUS_A").solve(np.asarray(b))


def solve_from_zero(pde, params):
    """(u, CG info, solver) of the model's linear solve from u = 0."""
    u0 = jnp.zeros(pde.n_dofs)
    solver = pde.make_solver(u0, params)
    r = pde.residual(u0, params)
    u = -solver.solve(r)
    return np.asarray(u), solver.last_info, solver, np.asarray(r)


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def poisson(n=1024):
    mesh = createUnitSquareMesh(n, n, "triangle")
    model = PoissonModel(mesh)
    rng = np.random.default_rng(0)
    kappa = 1.0 + 0.5 * rng.random(model.K.n_dofs)
    x = np.asarray(model.V.dof_coords)
    uex = np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])
    f = 2.0 * np.pi ** 2 * uex
    pde = model.fea.states["u"].pde
    t0 = time.perf_counter()
    u, info, solver, r = solve_from_zero(
        pde, {"kappa": jnp.asarray(kappa), "f": jnp.asarray(f)})
    t_solve = time.perf_counter() - t0
    ud = -direct_solve(solver, r)
    say("poisson", n_dofs=pde.n_dofs, cells=mesh.n_cells,
        compliance=float(np.dot(f, u)), mms_max_err=float(np.abs(u - uex).max()),
        cg_iters=int(info["iters"]), cg_resnorm=float(info["resnorm"]),
        nodal_err_vs_direct=rel(u, ud), solve_s=t_solve)


def nonlinear(n=512):
    mesh = createUnitSquareMesh(n, n, "triangle")
    nlp = NonlinearPoissonModel(mesh, newton_iters=8)
    rng = np.random.default_rng(3)
    kappa = jnp.asarray(1.0 + 0.5 * rng.random(nlp.K.n_dofs))
    x = np.asarray(nlp.V.dof_coords)
    f = jnp.asarray(40.0 * np.sin(np.pi * x[:, 0]) * x[:, 1])
    u_c, info = nlp.solve_checked(kappa, f)
    out = nlp.evaluate(kappa, f)
    pde = nlp.fea.states["u"].pde
    u_f = np.asarray(out.u)
    rn = float(jnp.linalg.norm(pde.residual(out.u, {"kappa": kappa,
                                                    "f": f})))
    say("nonlinear", n_dofs=pde.n_dofs, newton_iters=int(info["iters"]),
        newton_resnorm=float(info["resnorm"]),
        compliance=float(out.compliance),
        compliance_checked=float(jnp.vdot(f, u_c)),
        fixed_resnorm=rn, fixed_vs_checked=rel(u_f, np.asarray(u_c)))


def elasticity(nx, ny, part):
    L, H, E, q = 10.0, 1.0, 1e6, -1.0
    mesh = createRectangleMesh(nx, ny, (0, 0), (L, H), "quad")
    m = ElasticityModel(mesh, E=E, nu=0.0)
    f = np.zeros((mesh.n_nodes, 2))
    f[:, 1] = q
    params = {"thickness": jnp.ones(mesh.n_cells),
              "f": jnp.asarray(f.reshape(-1))}
    pde = m.fea.states["u"].pde
    t0 = time.perf_counter()
    u, info, solver, r = solve_from_zero(pde, params)
    t_solve = time.perf_counter() - t0
    ud = -direct_solve(solver, r)
    nf = m.VF.n_dofs
    areas = np.asarray(m.fea.outputs["volume"].fn(
        {"thickness": jnp.ones(mesh.n_cells)}))
    say(part, n_dofs=pde.n_dofs, cells=mesh.n_cells,
        compliance=float(np.dot(f.reshape(-1), u[:nf])), volume=float(areas),
        tip=float(np.abs(u.reshape(-1, 2)[:, 1]).max()),
        cg_iters=int(info["iters"]), cg_resnorm=float(info["resnorm"]),
        maxiter=solver.maxiter, nodal_err_vs_direct=rel(u, ud),
        solve_s=t_solve)


def beam():
    bm = EulerBernoulliBeamModel(nel=50)
    prob = OptimizationProblem(lambda dv: bm.evaluate(dv["thickness"]))
    prob.add_design_variable("thickness", 0.1 * np.ones(50), lower=1e-2,
                             upper=10.0)
    prob.set_objective("compliance")
    prob.add_constraint("volume", equals=0.01)
    dvs, res = prob.solve(maxiter=1000, ftol=1e-9, report=False)
    th = np.asarray(dvs["thickness"])
    say("beam", scipy=scipy.__version__, fun=float(res.fun), nit=res.nit,
        nfev=res.nfev, njev=res.njev, success=res.success,
        thickness_sum=float(th.sum()), thickness_first=float(th[0]),
        thickness_last=float(th[-1]))


def main():
    parts = sys.argv[1:] or ["poisson", "nonlinear", "elasticity",
                             "elasticity160", "beam"]
    run = {"poisson": poisson, "nonlinear": nonlinear,
           "elasticity": lambda: elasticity(320, 32, "elasticity"),
           "elasticity160": lambda: elasticity(160, 16, "elasticity160"),
           "beam": beam}
    for part in parts:
        t0 = time.perf_counter()
        run[part]()
        print(f"[{part}] seconds {time.perf_counter() - t0:.1f}", flush=True)


if __name__ == "__main__":
    main()
