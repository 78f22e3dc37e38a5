"""The generic FEA library of the port on the CPU, against the live JAX
package: PoissonModel (12x12 and 6x6 triangles), NonlinearPoissonModel
(12x12, newton_iters=8, both Newton surfaces), ElasticityModel (Q2, 40x4
and 20x2 quads), the Hermite EulerBernoulliBeamModel (nel 50, evaluate and
gradient), LinearSolver's Jacobi default, GMRES and symmetric=False
(the transposed fused operator and the dense LU), solvers/precond.py,
newton_solve, cg_solve's x0 / atol, FEA.solveLinearFwd / solveLinearBwd
and add_exact_solution / compute_error, and a state-dependent
extra_residual (the Poisson form plus 50 u: its linearization enters the
operator of the forward and adjoint solves, CG and dense).

Inputs are made with numpy from a seed and handed to both packages; f64
throughout; the reference runs with its FEMO_* solver flags unset.
Tolerances: 1e-9 relative for states, outputs and gradients of the
iterative solves (both packages run point-Jacobi CG or GMRES to a
relative residual of 1e-12 / 1e-13 on systems whose condition numbers are
below 1e5, the same arithmetic in another summation order), 1e-12 for the
dense LU and the preconditioners (closed form), 1e-8 for the beam (its
constrained stiffness has condition number 1.8e8, so eps x cond = 4e-8
bounds two dense solves' distance; measured 2e-10 on the displacements,
1.2e-9 on the gradient), and equal Newton iteration counts."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from femo_alpha_tpu.assembly.assemble import element_matrices as ref_em
from femo_alpha_tpu.fea import FEA as RefFEA
from femo_alpha_tpu.fea import FEAModel as RefFEAModel
from femo_alpha_tpu.mesh import createRectangleMesh as ref_rect
from femo_alpha_tpu.mesh import createUnitSquareMesh as ref_square
from femo_alpha_tpu.models import ElasticityModel as RefElasticity
from femo_alpha_tpu.models import EulerBernoulliBeamModel as RefBeam
from femo_alpha_tpu.models import NonlinearPoissonModel as RefNonlinear
from femo_alpha_tpu.models import PoissonModel as RefPoisson
from femo_alpha_tpu.solvers import precond as ref_precond
from femo_alpha_tpu.solvers.krylov import cg_solve as ref_cg
from femo_alpha_tpu.solvers.linear import LinearSolver as RefLinearSolver
from femo_alpha_tpu.spaces import FunctionSpace as RefFS
from femo_alpha_tpu.spaces import MixedSpace as RefMS

from femo_alpha_tpu_torch.assembly.assemble import element_matrices
from femo_alpha_tpu_torch.fea import FEA, FEAModel
from femo_alpha_tpu_torch.mesh import createRectangleMesh, createUnitSquareMesh
from femo_alpha_tpu_torch.models import (
    ElasticityModel,
    EulerBernoulliBeamModel,
    NonlinearPoissonModel,
    PoissonModel,
)
from femo_alpha_tpu_torch.solvers import newton_solve, precond
from femo_alpha_tpu_torch.solvers.krylov import cg_solve
from femo_alpha_tpu_torch.solvers.linear import LinearSolver
from femo_alpha_tpu_torch.spaces import FunctionSpace, MixedSpace

REF_FLAGS = ("FEMO_MG_F32", "FEMO_LANE_MAJOR", "FEMO_HOSTLOOP", "FEMO_CG_DF",
             "FEMO_OP_STORAGE")
BAR = 1e-9        # iterative solves
DENSE_BAR = 1e-12  # dense LU and closed-form results
BEAM_BAR = 1e-8  # the beam's dense solves (condition number 1.8e8)


def _rel(a, b):
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module", autouse=True)
def one_thread_and_ref_flags():
    """One intra-op thread for this module's torch work (the tests run
    beside other workers) and the reference's solver flags unset."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for flag in REF_FLAGS:
            mp.delenv(flag, raising=False)
        yield
    torch.set_num_threads(n)


def _poisson_inputs(V, K, seed=0):
    """kappa = 1 + 0.5 U[0, 1) (DG0), f = 2 pi^2 sin(pi x) sin(pi y)."""
    kappa = 1.0 + 0.5 * np.random.default_rng(seed).random(K.n_dofs)
    x = np.asarray(V.dof_coords)
    f = 2.0 * np.pi ** 2 * np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])
    return kappa, f


def _value_and_grads(evaluate, output, args):
    """The port's output and its gradient in every argument."""
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = evaluate(*ts)
    val = getattr(out, output)
    val.backward()
    return out, float(val.detach()), [t.grad for t in ts]


def _ref_value_and_grads(evaluate, output, args):
    def fn(*a):
        return jnp.reshape(getattr(evaluate(*a), output), ())

    val, grads = jax.value_and_grad(fn, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    return float(val), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n", [12, 6])
def test_poisson_model_matches_reference(n):
    """State, compliance and its gradients in kappa and f; compute_error
    against the registered exact solution."""
    m = PoissonModel(createUnitSquareMesh(n, n, "triangle"), device="cpu")
    rm = RefPoisson(ref_square(n, n, "triangle"))
    kappa, f = _poisson_inputs(m.V, m.K)
    out, J, grads = _value_and_grads(m.evaluate, "compliance", (kappa, f))
    J_r, grads_r = _ref_value_and_grads(rm.evaluate, "compliance",
                                        (kappa, f))
    assert _rel(out.u, rm.evaluate(kappa, f).u) <= BAR
    assert abs(J / J_r - 1.0) <= BAR
    for g, g_r in zip(grads, grads_r):
        assert _rel(g, g_r) <= BAR
    assert float(out.mean_u.detach()) == pytest.approx(
        float(rm.evaluate(kappa, f).mean_u), rel=BAR)
    info = m.fea.states["u"].pde.last_info
    assert info["forward"]["converged"] and info["adjoint"]["converged"]

    def exact(x):
        return np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])

    m.fea.add_exact_solution("u", exact)
    rm.fea.add_exact_solution("u", exact)
    err = m.fea.compute_error("u", out.u.detach())
    assert err == pytest.approx(rm.fea.compute_error("u", out.u.detach()
                                                     .numpy()), rel=1e-13)
    assert 0.0 < err < 0.2


def test_solve_linear_fwd_and_bwd_match_reference():
    """FEA.solveLinearFwd (J du = dR) and solveLinearBwd (J^T lam = g with
    BC rows zeroed) on the 12x12 Poisson state."""
    m = PoissonModel(createUnitSquareMesh(12, 12, "triangle"), device="cpu")
    rm = RefPoisson(ref_square(12, 12, "triangle"))
    kappa, f = _poisson_inputs(m.V, m.K)
    rng = np.random.default_rng(11)
    u, dR, g = (rng.standard_normal(m.V.n_dofs) for _ in range(3))
    p = {"kappa": torch.tensor(kappa), "f": torch.tensor(f)}
    p_r = {"kappa": jnp.asarray(kappa), "f": jnp.asarray(f)}
    du = m.fea.solveLinearFwd("u", torch.tensor(u), p, torch.tensor(dR))
    lam = m.fea.solveLinearBwd("u", torch.tensor(u), p, torch.tensor(g))
    assert _rel(du, rm.fea.solveLinearFwd("u", jnp.asarray(u), p_r,
                                          jnp.asarray(dR))) <= BAR
    lam_r = rm.fea.solveLinearBwd("u", jnp.asarray(u), p_r, jnp.asarray(g))
    assert _rel(lam, lam_r) <= BAR
    bc = np.asarray(m.fea.states["u"].pde.free_mask) == 0.0
    assert bc.any() and float(lam[torch.tensor(bc)].abs().max()) == 0.0


@pytest.fixture(scope="module")
def nonlinear():
    m = NonlinearPoissonModel(createUnitSquareMesh(12, 12, "triangle"),
                              newton_iters=8, device="cpu")
    rm = RefNonlinear(ref_square(12, 12, "triangle"), newton_iters=8)
    rng = np.random.default_rng(3)
    kappa = 1.0 + 0.5 * rng.random(m.K.n_dofs)
    x = np.asarray(m.V.dof_coords)
    f = 40.0 * np.sin(np.pi * x[:, 0]) * x[:, 1]
    return m, rm, kappa, f


def test_nonlinear_fixed_trip_newton_matches_reference(nonlinear):
    """evaluate (8 fixed Newton steps, the adjoint re-linearized at the
    returned state): state, compliance and its gradients in kappa and f."""
    m, rm, kappa, f = nonlinear
    out, J, grads = _value_and_grads(m.evaluate, "compliance", (kappa, f))
    J_r, grads_r = _ref_value_and_grads(rm.evaluate, "compliance",
                                        (kappa, f))
    assert _rel(out.u, rm.evaluate(kappa, f).u) <= BAR
    assert abs(J / J_r - 1.0) <= BAR
    for g, g_r in zip(grads, grads_r):
        assert _rel(g, g_r) <= BAR
    assert len(m.fea.states["u"].pde.last_info["newton"]) == 8


def test_nonlinear_checked_newton_matches_reference(nonlinear):
    """solve_checked (newton_solve with convergence control): the JAX run's
    iteration count and state; the fixed-trip state lies on it; a too-tight
    tolerance raises."""
    m, rm, kappa, f = nonlinear
    u, info = m.solve_checked(kappa, f)
    u_r, info_r = rm.solve_checked(jnp.asarray(kappa), jnp.asarray(f))
    assert info["converged"] and info["iters"] == info_r["iters"]
    assert 2 <= info["iters"] <= 8
    assert _rel(u, u_r) <= BAR
    u_fixed = m.evaluate(kappa, f).u.detach()
    assert float(torch.linalg.norm(u_fixed - u) / torch.linalg.norm(u)) \
        < 1e-10
    with pytest.raises(RuntimeError, match="Newton failed"):
        m.solve_checked(kappa, f, atol=1e-30, rtol=1e-30, max_it=2)


def test_newton_solve_on_a_scalar_equation():
    """newton_solve on r(u) = u^3 - 2: quadratic convergence to 2^(1/3),
    info as the reference reports it."""
    u, info = newton_solve(lambda u: u ** 3 - 2.0,
                           lambda u, r: r / (3.0 * u ** 2),
                           torch.ones(1, dtype=torch.float64))
    assert info["converged"] and info["iters"] <= 6
    assert float(u) == pytest.approx(2.0 ** (1.0 / 3.0), rel=1e-14)
    assert info["resnorm"] <= 1e-10


@pytest.mark.parametrize("nx,ny", [(40, 4), (20, 2)])
def test_elasticity_model_matches_reference(nx, ny):
    """The Q2 cantilever of tests/test_models_basic.py (E = 1e6, nu = 0,
    q = -1, seeded thickness): state, compliance, volume and the
    compliance gradient in thickness and load."""
    L, H = 10.0, 1.0
    mesh = createRectangleMesh(nx, ny, (0, 0), (L, H), "quad")
    m = ElasticityModel(mesh, E=1e6, nu=0.0, device="cpu")
    rm = RefElasticity(ref_rect(nx, ny, (0, 0), (L, H), "quad"), E=1e6,
                       nu=0.0)
    f = np.zeros((mesh.n_nodes, 2))
    f[:, 1] = -1.0
    t = 1.0 + 0.2 * np.random.default_rng(4).random(mesh.n_cells)
    out, J, grads = _value_and_grads(m.evaluate, "compliance",
                                     (t, f.reshape(-1)))
    J_r, grads_r = _ref_value_and_grads(rm.evaluate, "compliance",
                                        (t, f.reshape(-1)))
    ref_out = rm.evaluate(t, f.reshape(-1))
    assert _rel(out.u, ref_out.u) <= BAR
    assert abs(J / J_r - 1.0) <= BAR
    assert float(out.volume) == pytest.approx(float(ref_out.volume),
                                              rel=1e-14)
    for g, g_r in zip(grads, grads_r):
        assert _rel(g, g_r) <= BAR


def test_beam_matches_reference():
    """The Hermite cantilever at nel 50 (dense path): displacements,
    compliance, volume and d compliance / d thickness at a seeded design."""
    m = EulerBernoulliBeamModel(nel=50, device="cpu")
    rm = RefBeam(nel=50)
    th = 0.1 * (1.0 + 0.3 * np.random.default_rng(2).random(50))
    out, J, (g,) = _value_and_grads(m.evaluate, "compliance", (th,))
    J_r, (g_r,) = _ref_value_and_grads(rm.evaluate, "compliance", (th,))
    ref_out = rm.evaluate(th)
    assert _rel(out.displacements, ref_out.displacements) <= BEAM_BAR
    assert abs(J / J_r - 1.0) <= BEAM_BAR
    assert float(out.volume) == pytest.approx(float(ref_out.volume),
                                              rel=1e-14)
    assert _rel(g, g_r) <= BEAM_BAR


@pytest.fixture(scope="module")
def poisson_system():
    """The 12x12 P1 Poisson blocks of both packages (kappa = 1): cell-major
    element matrices, the lane-major port copy, the BC mask and a seeded
    right-hand side."""
    V = FunctionSpace(createUnitSquareMesh(12, 12, "triangle"), "P", 1)
    m = PoissonModel(V.mesh, device="cpu")
    pde = m.fea.states["u"].pde
    n = V.n_dofs
    p = {"kappa": torch.ones(m.K.n_dofs, dtype=torch.float64),
         "f": torch.zeros(n, dtype=torch.float64)}
    Ae = element_matrices(pde.form, torch.zeros(n, dtype=torch.float64), p)
    RV = RefFS(ref_square(12, 12, "triangle"), "P", 1)
    b = np.random.default_rng(12).standard_normal(n)
    return dict(V=V, RV=RV, Ae=Ae, free=pde.free_mask, b=b, n=n)


def test_jacobi_gmres_matches_reference(poisson_system):
    """LinearSolver(method='gmres') with its default Jacobi against the JAX
    package's (jax.scipy's batched GMRES, restart 50)."""
    s = poisson_system
    ls = LinearSolver([(s["Ae"].permute(1, 2, 0).contiguous(), s["V"])],
                      s["n"], free_mask=s["free"], method="gmres", tol=1e-12)
    x = ls.solve(torch.tensor(s["b"]) * s["free"])
    rls = RefLinearSolver([(jnp.asarray(s["Ae"].numpy()), s["RV"])], s["n"],
                          free_mask=jnp.asarray(s["free"].numpy()),
                          method="gmres", tol=1e-12)
    x_r = rls.solve(jnp.asarray(s["b"] * s["free"].numpy()))
    assert ls.last_info["converged"] and ls.last_info["cycles"] >= 1
    assert _rel(x, x_r) <= BAR


@pytest.mark.parametrize("method", ["gmres", "dense"])
def test_non_symmetric_solver_matches_reference(poisson_system, method):
    """symmetric=False on a seeded non-symmetric operator (the Poisson
    blocks plus 0.1 x their scale of random non-symmetric entries): the
    forward and the transposed solve by GMRES over the fused operator on
    Ae and on its transposed blocks, or by a dense LU."""
    s = poisson_system
    Ae = s["Ae"] + 0.1 * torch.tensor(
        np.random.default_rng(13).standard_normal(tuple(s["Ae"].shape)))
    ls = LinearSolver([(Ae.permute(1, 2, 0).contiguous(), s["V"])], s["n"],
                      free_mask=s["free"], method=method, tol=1e-12,
                      symmetric=False)
    rls = RefLinearSolver([(jnp.asarray(Ae.numpy()), s["RV"])], s["n"],
                          free_mask=jnp.asarray(s["free"].numpy()),
                          method=method, tol=1e-12, symmetric=False)
    b = torch.tensor(s["b"]) * s["free"]
    bar = BAR if method == "gmres" else DENSE_BAR
    x, xT = ls.solve(b), ls.solve_transpose(b)
    assert _rel(x, rls.solve(jnp.asarray(b.numpy()))) <= bar
    assert _rel(xT, rls.solve_transpose(jnp.asarray(b.numpy()))) <= bar
    assert float(torch.linalg.norm(x - xT) / torch.linalg.norm(x)) > 1e-3
    if method == "gmres":
        assert _rel(ls.matvecT(x), rls.matvecT(jnp.asarray(x.numpy()))) \
            <= 1e-13


def test_cg_solve_from_x0_with_atol_matches_reference(poisson_system):
    """cg_solve from a seeded x0 with an absolute tolerance."""
    s = poisson_system
    ls = LinearSolver([(s["Ae"].permute(1, 2, 0).contiguous(), s["V"])],
                      s["n"], free_mask=s["free"])
    rls = RefLinearSolver([(jnp.asarray(s["Ae"].numpy()), s["RV"])], s["n"],
                          free_mask=jnp.asarray(s["free"].numpy()))
    b = torch.tensor(s["b"]) * s["free"]
    x0 = 0.1 * torch.tensor(np.random.default_rng(14).standard_normal(s["n"]))
    x, info = cg_solve(ls.matvec, b, x0=x0, M=ls.M, tol=0.0, atol=1e-9,
                       maxiter=500)
    x_r, info_r = ref_cg(rls.matvec, jnp.asarray(b.numpy()),
                         x0=jnp.asarray(x0.numpy()), M=rls.M, tol=0.0,
                         atol=1e-9, maxiter=500)
    assert info["iters"] == int(info_r["iters"])
    assert info["converged"] and info["resnorm"] <= 1e-9
    assert _rel(x, x_r) <= BAR


def test_preconditioners_match_reference():
    """jacobi_preconditioner, mixed_block_jacobi and
    block_jacobi_preconditioner on seeded SPD element blocks of the RM
    shell's mixed space (CG2 vec3 x CG1 vec3, 4x2 quads), with a BC
    mask."""
    kw = dict(nx=4, ny=2, p0=(0, 0), p1=(2.0, 1.0), cell_type="quad",
              gdim=3, structured=False)
    mesh, rmesh = createRectangleMesh(**kw), ref_rect(**kw)
    W = MixedSpace(FunctionSpace(mesh, "P", 2, 3),
                   FunctionSpace(mesh, "P", 1, 3))
    RW = RefMS(RefFS(rmesh, "P", 2, 3), RefFS(rmesh, "P", 1, 3))
    rng = np.random.default_rng(15)
    nc, nd, n = mesh.n_cells, W.nd_local, W.n_dofs
    R = rng.standard_normal((nc, nd, nd))
    Ae = R @ R.transpose(0, 2, 1) + nd * np.eye(nd)
    AeT = torch.tensor(Ae).permute(1, 2, 0).contiguous()
    free = np.ones(n)
    free[rng.choice(n, 20, replace=False)] = 0.0
    v = rng.standard_normal(n)
    ft, vt = torch.tensor(free), torch.tensor(v)
    fj, vj = jnp.asarray(free), jnp.asarray(v)
    M = precond.jacobi_preconditioner(AeT, W, n, ft)
    M_r = ref_precond.jacobi_preconditioner(jnp.asarray(Ae),
                                            jnp.asarray(W.dofmap), n, fj)
    assert _rel(M(vt), M_r(vj)) <= DENSE_BAR
    M = precond.mixed_block_jacobi(AeT, W, ft)
    M_r = ref_precond.mixed_block_jacobi(jnp.asarray(Ae), RW, fj)
    assert _rel(M(vt), M_r(vj)) <= DENSE_BAR
    sub = W.subspaces[1]
    args = (sub.n_scalar_dofs, 3)
    kw = dict(local_offset=W.local_slices[1].start, n_dofs=n,
              global_offset=int(W.offsets[1]))
    M = precond.block_jacobi_preconditioner(AeT, sub.scalar_dofmap, *args,
                                            free_mask=ft, **kw)
    M_r = ref_precond.block_jacobi_preconditioner(
        jnp.asarray(Ae), jnp.asarray(sub.scalar_dofmap), *args, free_mask=fj,
        **kw)
    assert _rel(M(vt), M_r(vj)) <= DENSE_BAR
    assert torch.equal(M(vt)[:kw["global_offset"]],
                       vt[:kw["global_offset"]])


def test_reference_element_matrices_agree(poisson_system):
    """The port's torch.func element matrices of the Poisson form equal the
    JAX package's jacfwd ones (the blocks every solver test above feeds to
    both packages come from the port)."""
    s = poisson_system
    rm = RefPoisson(ref_square(12, 12, "triangle"))
    rpde = rm.fea.states["u"].pde
    n = s["n"]
    Ae_r = ref_em(rpde.form, jnp.zeros(n), {"kappa": jnp.ones(rm.K.n_dofs),
                                            "f": jnp.zeros(n)})
    assert _rel(s["Ae"], Ae_r) <= DENSE_BAR


def test_plain_precond_factory_matches_reference():
    """A plain solver_opts["precond_factory"](u, params) -> M (no split
    protocol) is called at each linearization, as the JAX package's
    make_solver calls it: an unscaled identity factory gives the JAX
    package's unpreconditioned state and gradient on the 6x6 Poisson."""
    calls = []

    def factory(u, params):
        calls.append(sorted(params))
        return lambda v: v

    opts = {"method": "cg", "tol": 1e-12, "precond_factory": factory}
    m = PoissonModel(createUnitSquareMesh(6, 6, "triangle"),
                     solver_opts=dict(opts), device="cpu")
    rm = RefPoisson(ref_square(6, 6, "triangle"), solver_opts=dict(opts))
    kappa, f = _poisson_inputs(m.V, m.K)
    calls.clear()
    out, J, grads = _value_and_grads(m.evaluate, "compliance", (kappa, f))
    assert calls == [["f", "kappa"]]
    J_r, grads_r = _ref_value_and_grads(rm.evaluate, "compliance",
                                        (kappa, f))
    assert abs(J / J_r - 1.0) <= BAR
    for g, g_r in zip(grads, grads_r):
        assert _rel(g, g_r) <= BAR


EXTRA_C = 50.0


def _extra_fea(fea_cls, model_cls, m, opts, extra):
    """model m's Poisson form re-registered in a new FEA (fea_cls, of
    either package) with extra_residual `extra` and m's strong BCs."""
    kw = {} if fea_cls is RefFEA else {"device": "cpu"}
    fea = fea_cls(m.mesh, **kw)
    fea.add_input("kappa", m.K)
    fea.add_input("f", m.V)
    fea.add_state("u", m.fea.states["u"].form, arguments=["kappa", "f"],
                  extra_residual=extra, solver_opts=dict(opts))
    for bc in m.fea.bcs:
        fea.add_strong_bc(bc.dofs, bc.values)
    dot = torch.dot if fea_cls is FEA else jnp.dot
    fea.add_output("compliance", fn=lambda v: dot(v["f"], v["u"]))
    return fea, model_cls(fea=[fea])


def _extra_inputs(m, seed=0):
    """kappa = 1 + U[0, 1) (DG0), then f = U[0, 1) (P1), one generator."""
    rng = np.random.default_rng(seed)
    kappa = 1.0 + rng.random(m.K.n_dofs)
    return kappa, rng.random(m.V.n_dofs)


def _extra_pair(opts, n=8):
    m = PoissonModel(createUnitSquareMesh(n, n, "triangle"), device="cpu")
    rm = RefPoisson(ref_square(n, n, "triangle"))
    fea, model = _extra_fea(FEA, FEAModel, m, opts,
                            lambda u, p: EXTRA_C * u)
    _, ref = _extra_fea(RefFEA, RefFEAModel, rm, opts,
                        lambda u, p: EXTRA_C * u)
    return m, fea, model, ref


def _extra_compare(model, ref, m, bar):
    kappa, f = _extra_inputs(m)
    out, J, grads = _value_and_grads(
        lambda k, f_: model.evaluate({"kappa": k, "f": f_}), "compliance",
        (kappa, f))
    J_r, grads_r = _ref_value_and_grads(
        lambda k, f_: ref.evaluate({"kappa": k, "f": f_}), "compliance",
        (kappa, f))
    u_r = ref.evaluate({"kappa": jnp.asarray(kappa),
                        "f": jnp.asarray(f)}).u
    assert _rel(out.u, u_r) <= bar
    assert abs(J / J_r - 1.0) <= bar
    for g, g_r in zip(grads, grads_r):
        assert _rel(g, g_r) <= bar
    return out


def test_state_dependent_extra_residual_matches_reference():
    """A Poisson problem with extra_residual = 50 u through FEAModel
    (createUnitSquareMesh(8, 8), P1, Jacobi-CG to 1e-12): the term's
    linearization enters the forward and the adjoint operator, so the
    state (max |u| 2.64e-4, not the 2.81e-2 of the operator without it),
    the compliance and both gradients match the live JAX model at 1e-9."""
    m, fea, model, ref = _extra_pair({"method": "cg", "tol": 1e-12})
    out = _extra_compare(model, ref, m, BAR)
    assert float(out.u.detach().abs().max()) < 1e-3
    pde = fea.states["u"].pde
    assert pde.last_info["forward"]["converged"]
    assert pde.last_info["adjoint"]["converged"]


def test_state_dependent_extra_residual_dense_path_matches_reference():
    """The same problem on the dense path: the term's columns join the
    dense matrix before the BCs, as in the JAX package (state, compliance
    and gradients at 1e-12)."""
    m, _, model, ref = _extra_pair({"method": "dense"})
    _extra_compare(model, ref, m, DENSE_BAR)


def test_extra_residual_linearization_and_gradient():
    """The linearization enters the solver only where it is not zero (a
    load term keeps the plain operator); the transposed operator of a
    non-symmetric solver carries the term's transpose; and the kappa
    gradient of the extra_residual problem agrees with a central
    difference to 1e-6."""
    m, fea, model, _ = _extra_pair({"method": "cg", "tol": 1e-12})
    kappa, f = _extra_inputs(m)
    params = {"kappa": torch.tensor(kappa), "f": torch.tensor(f)}
    pde = fea.states["u"].pde
    u = torch.tensor(np.random.default_rng(2).random(m.V.n_dofs))
    ls = pde.make_solver(u, params)
    x = torch.tensor(np.random.default_rng(3).standard_normal(m.V.n_dofs))
    free = pde.free_mask
    assert ls.extra_matvec is not None
    plain = PoissonModel(m.mesh, device="cpu").fea.states["u"].pde
    torch.testing.assert_close(
        ls.matvec(x), plain.make_solver(u, params).matvec(x)
        + EXTRA_C * free * free * x, rtol=1e-14, atol=1e-14)
    load_fea, _ = _extra_fea(FEA, FEAModel, m, {"method": "cg"},
                             lambda u_, p: -0.5 * p["f"])
    assert load_fea.states["u"].pde.make_solver(
        u, params).extra_matvec is None
    ns = LinearSolver(ls.ops, m.V.n_dofs, free_mask=free, symmetric=False,
                      method="gmres", extra_matvec=lambda v: EXTRA_C * v
                      + torch.roll(v, 1))
    y = torch.tensor(np.random.default_rng(4).standard_normal(m.V.n_dofs))
    assert abs(float(torch.dot(ns.matvecT(y), x) - torch.dot(
        y, ns.matvec(x)))) <= 1e-12 * float(torch.dot(y, ns.matvec(x)).abs())
    kt = params["kappa"].clone().requires_grad_(True)
    J = model.evaluate({"kappa": kt, "f": params["f"]}).compliance
    J.backward()
    d = torch.tensor(np.random.default_rng(5).standard_normal(len(kappa)))
    eps = 1e-6
    with torch.no_grad():
        Jp, Jm = (float(model.evaluate({"kappa": params["kappa"] + s * d,
                                        "f": params["f"]}).compliance)
                  for s in (eps, -eps))
    fd = (Jp - Jm) / (2 * eps)
    assert abs(fd - float(torch.dot(kt.grad, d))) <= 1e-6 * abs(fd)
