"""The force-to-pressure map of the port on the CPU, against the live JAX
package: RMShellPDE.make_force_to_pressure_solver (the differentiable
solve of (VF mass matrix) p = F: point-Jacobi CG at tol 1e-12 over the
fused operator, as the JAX package's LinearSolver defaults to) and RMShellModel.evaluate(is_pressure=False) on the
generated wing createWingShellMesh(6, 10, rib_stations=(5,)) (penalty
BCs, n_dofs <= 6000: both packages take the dense f64 Cholesky path), and
the PlateSim `sim.pde` call of
examples/advanced_examples/lpc_gust_response_opt/ex_lpc_gust_like_opt.py
on its 6 x 10 wing.

Inputs are made with numpy from a seed and handed to both packages; f64
throughout; the reference runs with its FEMO_* solver flags unset
(FEMO_MG_F32, FEMO_LANE_MAJOR, FEMO_HOSTLOOP, FEMO_CG_DF, FEMO_OP_STORAGE).
Tolerances: 1e-10 relative for the pressure field and its vjp (two CG
solves to 1e-12 of a mass matrix whose condition number is a few
hundred), 1e-8 for the model's outputs (100 x 1e-8 for the p-norm,
sigma^100) and 1e-6 for its gradients, as tests/test_torch_wing.py holds
the wing model."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from femo_alpha_tpu.mesh import createWingShellMesh as ref_wing
from femo_alpha_tpu.models import RMShellModel as RefModel
from femo_alpha_tpu.models.rm_shell.pde import RMShellPDE as RefPDE

from femo_alpha_tpu_torch.mesh import createWingShellMesh
from femo_alpha_tpu_torch.models import RMShellModel
from femo_alpha_tpu_torch.models.dynamic_rm_shell import PlateSim
from femo_alpha_tpu_torch.models.rm_shell.pde import RMShellPDE

REF_FLAGS = ("FEMO_MG_F32", "FEMO_LANE_MAJOR", "FEMO_HOSTLOOP", "FEMO_CG_DF",
             "FEMO_OP_STORAGE")
KW = dict(n_chord=6, n_span=10, rib_stations=(5,))
OUTPUTS = ("disp_solid", "compliance", "mass", "pnorm_stress",
           "aggregated_stress")


def _root(x):
    return np.abs(x[:, 1]) < 1e-9


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: the tests run
    beside other workers, and multithreaded f64 solves at these sizes are
    many times slower than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_env():
    with pytest.MonkeyPatch.context() as mp:
        for flag in REF_FLAGS:
            mp.delenv(flag, raising=False)
        yield


def _forces(nn, seed=5):
    """Seeded nodal forces (n_nodes, 3): a lift-like z part and small
    in-plane parts."""
    rng = np.random.default_rng(seed)
    f = 0.1 * rng.standard_normal((nn, 3))
    f[:, 2] += 1.0 + 0.2 * rng.uniform(size=nn)
    return f


def test_force_to_pressure_solver_matches_reference(ref_env):
    """p = M^-1 F and its vjp against the JAX package's solver."""
    mesh, rmesh = createWingShellMesh(**KW), ref_wing(**KW)
    solve = RMShellPDE(mesh, element_wise_material=True, device="cpu") \
        .make_force_to_pressure_solver()
    ref_solve = RefPDE(rmesh, element_wise_material=True) \
        .make_force_to_pressure_solver()
    F = _forces(mesh.n_nodes).reshape(-1)
    g = np.random.default_rng(6).standard_normal(F.shape)
    Ft = torch.tensor(F, requires_grad=True)
    p = solve(Ft)
    p.backward(torch.tensor(g))
    p_r, vjp = jax.vjp(ref_solve, jnp.asarray(F))
    assert _rel(p.detach(), p_r) <= 1e-10
    assert _rel(Ft.grad, vjp(jnp.asarray(g))[0]) <= 1e-10
    info = solve.pde.last_info
    assert 0 < info["forward"]["iters"] < 200
    assert info["forward"]["converged"] and info["adjoint"]["converged"]


def test_force_to_pressure_solve_is_jacobi_pcg_as_the_reference(ref_env):
    """The mass solve's preconditioner is the reference's: its
    {"method": "cg", "tol": 1e-12} reaches LinearSolver(pc="jacobi"), point
    Jacobi from the mass matrix's diagonal, so the port's CG takes the JAX
    run's iteration count (an unpreconditioned CG takes more)."""
    mesh, rmesh = createWingShellMesh(**KW), ref_wing(**KW)
    solve = RMShellPDE(mesh, element_wise_material=True, device="cpu") \
        .make_force_to_pressure_solver()
    ref_pde = RefPDE(rmesh, element_wise_material=True) \
        .make_force_to_pressure_solver().pde
    F = _forces(mesh.n_nodes).reshape(-1)
    p = solve(torch.tensor(F))
    params = {"F_vec": jnp.asarray(F)}
    u0 = jnp.zeros(ref_pde.n_dofs)
    ref_solver = ref_pde.make_solver(u0, params)
    p_r = -ref_solver.solve(ref_pde.residual(u0, params))
    assert _rel(p, p_r) <= 1e-10
    assert solve.pde.last_info["forward"]["iters"] == \
        int(ref_solver.last_info["iters"])


@pytest.fixture(scope="module")
def wing_reference(ref_env):
    """The JAX package's evaluate(is_pressure=False) on the wing: the
    outputs and the gradients of aggregated_stress in thickness and in the
    nodal forces."""
    mesh = ref_wing(**KW)
    nel, nn = mesh.n_cells, mesh.n_nodes
    model = RefModel(mesh, shell_bc_func=_root, element_wise_material=True)
    F = _forces(nn)
    th = 0.005 * (1.0 + 0.2 * np.random.default_rng(7).uniform(size=nel))
    mat = (jnp.full(nel, 71.7e9), jnp.full(nel, 0.33), jnp.full(nel, 2780.0))

    def agg(th_, F_):
        out = model.evaluate(F_, th_, *mat, is_pressure=False)
        return out.aggregated_stress, {k: getattr(out, k) for k in OUTPUTS}

    (_, outs), grads = jax.value_and_grad(agg, argnums=(0, 1),
                                          has_aux=True)(
        jnp.asarray(th), jnp.asarray(F))
    return ({k: np.asarray(v) for k, v in outs.items()},
            [np.asarray(x) for x in grads], F, th)


def test_evaluate_with_nodal_forces_matches_reference(wing_reference):
    ref, (g_th_r, g_F_r), F, th = wing_reference
    mesh = createWingShellMesh(**KW)
    model = RMShellModel(mesh, shell_bc_func=_root,
                         element_wise_material=True, device="cpu")
    assert model.shell_pde.W.n_dofs <= 6000  # the dense path
    nel = mesh.n_cells
    tt = torch.tensor(th, requires_grad=True)
    Ft = torch.tensor(F, requires_grad=True)
    out = model.evaluate(Ft, tt, np.full(nel, 71.7e9), np.full(nel, 0.33),
                         np.full(nel, 2780.0), is_pressure=False)
    for k in OUTPUTS:
        bar = 100 * 1e-8 if k.startswith("pnorm") else 1e-8
        assert _rel(getattr(out, k).detach(), ref[k]) <= bar, k
    out.aggregated_stress.backward()
    assert _rel(tt.grad, g_th_r) <= 1e-6
    assert Ft.grad.shape == F.shape
    assert _rel(Ft.grad, g_F_r) <= 1e-6


def test_plate_sim_force_to_pressure_of_the_lpc_example(ref_env):
    """ex_lpc_gust_like_opt.py's boom loads: point forces at the rib
    stations' leading-edge nodes, mapped to a force field by
    sim.pde.make_force_to_pressure_solver(), on the example's wing."""
    wing = dict(n_chord=6, n_span=10, span=10.0, root_chord=1.6, taper=0.5,
                sweep=0.3, rib_stations=(3, 7), shuffle_seed=11)
    mesh, rmesh = createWingShellMesh(**wing), ref_wing(**wing)
    sim = PlateSim(mesh, 69e9, 0.33, 2700.0, 0.005, 16,
                   element_wise_thickness=True,
                   custom_bc_func=lambda x: x[:, 1] < 1e-9,
                   add_self_weight=True, quad_deg=4, device="cpu")
    ref_pde = RefPDE(rmesh, element_wise_material=True, element_type="CG2CG1",
                     inplane_deg=4, shear_deg=4, stress_deg=4)
    nn = mesh.n_nodes
    F_boom = np.zeros(3 * nn)
    for j in (3, 7):
        y = 10.0 * j / 10
        t = y / 10.0
        le = np.array([0.3 * 10.0 * t, y, 0.0])
        b = int(np.argmin(np.linalg.norm(mesh.coords - le, axis=1)))
        F_boom[3 * b + 2] = -45.0 * 9.81
    p = sim.pde.make_force_to_pressure_solver()(torch.tensor(F_boom))
    p_r = ref_pde.make_force_to_pressure_solver()(jnp.asarray(F_boom))
    assert p.shape == (3 * nn,)
    assert _rel(p, p_r) <= 1e-10
