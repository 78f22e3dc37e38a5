"""Nodal (CG1) thickness and material, the default of RMShellModel and
PlateSim, on the CPU against the JAX package: the static plate on the
dense path (live) and on the MG path (pinned digits), the H1 thickness
regularization, the reordering of nodal fields by input_global_indices,
the transient PlateSim and evaluate_modal.

Inputs are made with numpy (femo_alpha_tpu_torch.benchmarks.
nodal_thickness, a smooth non-uniform field, and seeded random fields)
and handed to both packages; f64 throughout; the reference runs with its
FEMO_* solver flags unset (FEMO_MG_F32, FEMO_LANE_MAJOR, FEMO_HOSTLOOP,
FEMO_CG_DF, FEMO_OP_STORAGE). Digits pinned by
tools/nodal_reference_digits.py stand where the JAX call costs more than
~10 s (the 64x16 MG plate ~45 s, the 8x4 PlateSim ~60 s, the modal plate).
Tolerances: the 16x4 dense plate against live jax.grad at 1e-9 (state,
compliance) and 1e-8 (the nodal thickness gradient); the 64x16 MG plate
(16,086 dofs, two levels, both assembled directly) at 1e-8 / 1e-6 and the
same CG iterations, as chip_smoke.py holds the 128x32 plate; the H1
kernel and the compliance form at 1e-12 (closed form); PlateSim's total
strain energy and gradient at 1e-9 / 1e-8 (dense step solves); the modal
eigenvalues at 1e-8."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from femo_alpha_tpu.assembly.assemble import assemble_scalar as ref_scalar
from femo_alpha_tpu.mesh import createRectangleMesh as ref_rect
from femo_alpha_tpu.models import RMShellModel as RefModel

from femo_alpha_tpu_torch.assembly.assemble import assemble_scalar
from femo_alpha_tpu_torch.benchmarks import gust_history, nodal_thickness
from femo_alpha_tpu_torch.mesh import createRectangleMesh
from femo_alpha_tpu_torch.models import RMShellModel
from femo_alpha_tpu_torch.models.dynamic_rm_shell import PlateSim
from femo_alpha_tpu_torch.models.rm_shell.mg import ShellMGPrecond

REF_FLAGS = ("FEMO_MG_F32", "FEMO_LANE_MAJOR", "FEMO_HOSTLOOP", "FEMO_CG_DF",
             "FEMO_OP_STORAGE")
# tools/nodal_reference_digits.py (JAX package, CPU, f64)
PLATE64_DIGITS = {"compliance": 5.899922158555251e-04,
                  "grad_norm": 6.792505978658730e-04,
                  "grad_sum": -1.054421360981684e-02,
                  "cg_iters": [15, 15]}
SIM8_DIGITS = {"total_strain_energy": 6.043191701814245e-04,
               "grad_norm": 1.887666023060150e-03,
               "grad_sum": -1.120973876049994e-04}
MODAL_DIGITS = (6.443041074054199e+02, 6.107959643006992e+03,
                1.458950212478895e+04, 5.216462991964266e+04,
                6.764460010424186e+04)
KW = dict(dtype=torch.float64)


def _bc(x):
    return x[:, 0] < 1e-12


def _rel(a, b):
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   dtype=np.float64)
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


def _inputs(mesh):
    """The cantilever's load f_z = 2, the smooth nodal thickness, uniform
    E = 4.32e8, nu = 0, rho = 100 per node (numpy)."""
    nn = mesh.n_nodes
    f = np.zeros((nn, 3))
    f[:, 2] = 2.0
    return (f, nodal_thickness(np.asarray(mesh.coords)),
            np.full(nn, 4.32e8), np.zeros(nn), np.full(nn, 100.0))


def _port_grad(model, f, th, E, nu, rho):
    tt = torch.tensor(th, requires_grad=True)
    out = model.evaluate(f, tt, E, nu, rho)
    J = out.compliance
    J.backward()
    return out, float(J.detach()), tt.grad


@pytest.fixture(scope="module")
def plate16(ref_env):
    """The 16x4 plate (10 x 2, 1,146 dofs: the dense path), strong clamp
    at x = 0, the models' default nodal material, in both packages."""
    mesh = createRectangleMesh(16, 4, (0, 0), (10.0, 2.0), "quad", gdim=3)
    rmesh = ref_rect(16, 4, (0, 0), (10.0, 2.0), "quad", gdim=3)
    return dict(
        port=RMShellModel(mesh, shell_bc_func=_bc, PENALTY_BC=False,
                          device="cpu"),
        ref=RefModel(rmesh, shell_bc_func=_bc, PENALTY_BC=False),
        args=_inputs(mesh))


def test_static_plate_dense_matches_reference(plate16):
    """evaluate + compliance.backward() with nodal thickness, E, nu and
    density (the fine operator assembled directly, no affine basis): the
    state at 1e-9, the compliance (H1 regularization included) at 1e-9 and
    its gradient in the nodal thickness at 1e-8 against live jax.grad."""
    model, ref = plate16["port"], plate16["ref"]
    f, th, E, nu, rho = plate16["args"]
    pde = model.fea.states["disp_solid"].pde
    assert pde.element_matrices_fn is None
    assert pde.solver_opts["method"] == "dense"
    out, J, g = _port_grad(model, f, th, E, nu, rho)

    def J_ref(h):
        o = ref.evaluate(jnp.asarray(f), h, jnp.asarray(E), jnp.asarray(nu),
                         jnp.asarray(rho))
        return jnp.reshape(o.compliance, ()), o.disp_solid

    (J_r, u_r), g_r = jax.value_and_grad(J_ref, has_aux=True)(
        jnp.asarray(th))
    assert g.shape == (model.nn,)
    assert _rel(out.disp_solid, u_r) <= 1e-9
    assert abs(J / float(J_r) - 1.0) <= 1e-9
    assert _rel(g, g_r) <= 1e-8


def test_mg_path_matches_pinned_digits():
    """The 64x16 plate (16,086 dofs) on the MG path: two levels, each
    assembled directly at every setup (no basis, no K2); compliance at
    1e-8, |dJ/dh| and sum(dJ/dh) at 1e-6 and the forward and adjoint CG
    iterations equal to the JAX run's."""
    mesh = createRectangleMesh(64, 16, (0, 0), (10.0, 2.0), "quad", gdim=3)
    model = RMShellModel(mesh, shell_bc_func=_bc, PENALTY_BC=False,
                         device="cpu")
    pde = model.fea.states["disp_solid"].pde
    assert isinstance(pde._pc, ShellMGPrecond)
    assert len(model.mg.levels) == 2
    assert all("affine_asm" not in lev for lev in model.mg.levels)
    _, J, g = _port_grad(model, *_inputs(mesh))
    assert abs(J / PLATE64_DIGITS["compliance"] - 1.0) <= 1e-8
    assert abs(float(g.norm()) / PLATE64_DIGITS["grad_norm"] - 1.0) <= 1e-6
    assert abs(float(g.sum()) / PLATE64_DIGITS["grad_sum"] - 1.0) <= 1e-6
    assert [pde.last_info[k]["iters"] for k in ("forward", "adjoint")] == \
        PLATE64_DIGITS["cg_iters"]
    p = {k: v.detach() for k, v in model.fe_inputs(*_inputs(mesh)[:4],
                                                    node_disp=None).items()}
    assert pde._pc.prepare(p) == ()


def test_h1_regularization_kernel_matches_reference(plate16):
    """regularization_kernel("H1"), 0.5e-2 int |grad h|^2 dx with the P1
    thickness gradient, cell by cell, and the compliance form it enters
    (nodal thickness) on a seeded state, at 1e-12."""
    pde, rpde = plate16["port"].shell_pde, plate16["ref"].shell_pde
    rng = np.random.default_rng(7)
    th = 0.2 + 0.05 * rng.random(pde.mesh.n_nodes)
    kern, rkern = pde.regularization_kernel("H1"), \
        rpde.regularization_kernel("H1")
    conn, x = np.asarray(pde.mesh.conn), np.asarray(pde.mesh.coords)
    for c in (0, 17, 63):
        v = kern(None, torch.tensor(x[conn[c]]),
                 {"thickness": torch.tensor(th[conn[c]])})
        v_r = rkern(None, jnp.asarray(x[conn[c]]),
                    {"thickness": jnp.asarray(th[conn[c]])})
        assert float(v) > 0.0
        assert abs(float(v) / float(v_r) - 1.0) <= 1e-12
    u = 1e-3 * rng.standard_normal(pde.W.n_dofs)
    uhat = np.zeros(pde.VU.n_dofs)
    e = assemble_scalar(pde.compliance_form(), torch.tensor(u),
                        {"thickness": torch.tensor(th),
                         "uhat": torch.tensor(uhat)})
    e_r = ref_scalar(rpde.compliance_form(), jnp.asarray(u),
                     {"thickness": jnp.asarray(th),
                      "uhat": jnp.asarray(uhat)})
    assert abs(float(e) / float(e_r) - 1.0) <= 1e-12


def test_material_reordering_follows_input_global_indices(plate16):
    """On a mesh whose input_global_indices is a seeded permutation (and
    whose original_cell_index is another), nodal thickness, E, nu and
    density are reordered node by node: the compliance equals the
    identity-ordered model's at the reordered inputs, and the gradient
    comes back in the caller's node order (1e-12, both solves from
    zero); the JAX package,
    given the same mesh attributes, agrees at 1e-9."""
    mesh = createRectangleMesh(16, 4, (0, 0), (10.0, 2.0), "quad", gdim=3)
    rng = np.random.default_rng(11)
    nn, nel = mesh.n_nodes, mesh.n_cells
    perm = rng.permutation(nn)
    mesh.input_global_indices = perm
    mesh.original_cell_index = rng.permutation(nel)
    model = RMShellModel(mesh, shell_bc_func=_bc, PENALTY_BC=False,
                         device="cpu")
    f, th, E, nu, rho = plate16["args"]
    E = E * (1.0 + 0.2 * rng.random(nn))
    nu = 0.3 * rng.random(nn)
    # caller-ordered inputs whose FE-ordered values are (f, th, E, nu, rho)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(nn)
    args_c = [a[inv] for a in (f, th, E, nu, rho)]
    _, J_c, g_c = _port_grad(model, *args_c)
    # a fresh model: both solves start from zero
    ident = RMShellModel(createRectangleMesh(16, 4, (0, 0), (10.0, 2.0),
                                             "quad", gdim=3),
                         shell_bc_func=_bc, PENALTY_BC=False, device="cpu")
    _, J, g = _port_grad(ident, f, th, E, nu, rho)
    assert abs(J_c / J - 1.0) <= 1e-12
    assert _rel(g_c[perm], g) <= 1e-12
    rmesh = ref_rect(16, 4, (0, 0), (10.0, 2.0), "quad", gdim=3)
    rmesh.input_global_indices = perm
    rmesh.original_cell_index = mesh.original_cell_index
    plate16["ref"].mesh = rmesh
    try:
        J_r = plate16["ref"].evaluate(*[jnp.asarray(a) for a in args_c]
                                      ).compliance
    finally:
        plate16["ref"].mesh = plate16["port"].mesh
    assert abs(J_c / float(J_r) - 1.0) <= 1e-9


def test_platesim_nodal_matches_pinned_digits():
    """PlateSim with its default nodal thickness on the 8x4 plate, 3 steps
    of the gust, dense step solves: K and M assembled directly at the
    design; simulate_outputs + backward and the history path, total strain
    energy at 1e-9 and |d/dh| at 1e-8 against the JAX run's, and the two
    paths' gradients at 1e-10."""
    mesh = createRectangleMesh(8, 4, (0, 0), (10.0, 2.0), "quad", gdim=3)
    sim = PlateSim(mesh, E=4.32e8, nu=0.0, rho=100.0, dt=0.01, Nsteps=3,
                   device="cpu")
    assert sim.solver_method == "dense" and sim.num_var == mesh.n_nodes
    fh = torch.as_tensor(gust_history(mesh.n_nodes, 3, sim.dt))
    th = nodal_thickness(np.asarray(mesh.coords), h0=0.1)
    tt = torch.tensor(th, requires_grad=True)
    e = sim.simulate_outputs(tt, fh)["total_strain_energy"]
    e.backward()
    th2 = torch.tensor(th, requires_grad=True)
    wh = sim.simulate(th2, fh)
    e2 = sim.strain_energy_history(wh, th2).sum()
    e2.backward()
    d = SIM8_DIGITS
    for val in (float(e), float(e2)):
        assert abs(val / d["total_strain_energy"] - 1.0) <= 1e-9
    assert abs(float(tt.grad.norm()) / d["grad_norm"] - 1.0) <= 1e-8
    assert abs(float(tt.grad.sum()) / d["grad_sum"] - 1.0) <= 1e-8
    assert _rel(th2.grad, tt.grad) <= 1e-10


def test_modal_nodal_matches_pinned_digits():
    """evaluate_modal with nodal thickness, E, nu and density on the 8x4
    plate (2 x 1): the dense reduced eigh's eigenvalues at 1e-8 against
    the JAX package's, and LOBPCG (the nodal mass assembled directly and
    applied by the fused operator) at 1e-10 of the dense ones."""
    mesh = createRectangleMesh(8, 4, (0, 0), (2.0, 1.0), "quad", gdim=3)
    model = RMShellModel(mesh, shell_bc_func=_bc, PENALTY_BC=False,
                         device="cpu")
    x = np.asarray(mesh.coords)
    nn = mesh.n_nodes
    th = 0.02 * (1.0 + 0.3 * np.sin(np.pi * x[:, 0] / 2.0)
                 * np.cos(np.pi * x[:, 1]))
    args = (th, np.full(nn, 7.0e10), np.full(nn, 0.3), np.full(nn, 2700.0))
    lam = model.evaluate_modal(*args, n_modes=5, solver="dense").eigenvalues
    assert _rel(lam, MODAL_DIGITS) <= 1e-8
    lob = model.evaluate_modal(*args, n_modes=4, solver="lobpcg", tol=1e-10,
                               maxiter=100, seed=0)
    assert _rel(lob.eigenvalues, lam[:4]) <= 1e-10
