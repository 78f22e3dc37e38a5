"""Shape inputs of the port on the CPU, against the JAX package:
RMShellModel.evaluate(node_disp=...) (the mesh-motion field uhat through
the J(uhat) / F(uhat) pullbacks, shape gradients by autograd through the
implicit adjoint), the affine assembler's direct path while uhat requires
grad, the aeroelastic interface of
examples/advanced_examples/pav_shell_opt/ex_aeroelastic_interface.py and
evaluate_modal on a moved plate.

Inputs are made with numpy from a seed and handed to both packages; f64
throughout; the reference runs with its FEMO_* solver flags unset
(FEMO_MG_F32, FEMO_LANE_MAJOR, FEMO_HOSTLOOP, FEMO_CG_DF, FEMO_OP_STORAGE).
The design directions are in-plane: on a flat plate an out-of-plane (z)
motion has a zero first-order shape derivative (tests/test_shape_opt.py).
Tolerances: the 16x4 plate of tests/test_shape_opt.py (dense path)
against live jax.grad at 1e-10 (compliance) and 1e-8 (the node_disp
gradient), its Richardson central difference at 1e-5 as the reference
test holds it; the 64x16 plate (MG path, 6,630 dofs) against digits
pinned by tools/shape_reference_digits.py (its JAX run takes a minute) at
1e-8 (compliance) and 1e-6 (gradients: two CG solves to 1e-12 with
different preconditioners); the direct and the basis assembly of one
geometry at 1e-13, and the compliance and thickness gradient solved on
either at 1e-11 / 1e-9 (what the dense solve makes of a 4e-16 operator
difference: 1.5e-12 / 3.6e-11 measured); the aeroelastic interface (penalty BCs, dense) at 1e-8
and its gradients at 1e-6, as tests/test_torch_wing.py holds the wing;
the moved plate's eigenvalues (dense reduced eigh) at 1e-12, as
tests/test_torch_modal.py holds the unmoved one."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from femo_alpha_tpu.mesh import StructuredQuadMesh as RefSQM
from femo_alpha_tpu.mesh import createRectangleMesh as ref_rect
from femo_alpha_tpu.models import RMShellModel as RefModel

import femo_alpha_tpu_torch.assembly.affine as affine
from femo_alpha_tpu_torch.benchmarks import planform_direction, planform_shape
from femo_alpha_tpu_torch.examples import ex_aeroelastic_interface
from femo_alpha_tpu_torch.mesh import StructuredQuadMesh, createRectangleMesh
from femo_alpha_tpu_torch.models import RMShellModel

REF_FLAGS = ("FEMO_MG_F32", "FEMO_LANE_MAJOR", "FEMO_HOSTLOOP", "FEMO_CG_DF",
             "FEMO_OP_STORAGE")
# tools/shape_reference_digits.py plate64 (JAX package, CPU, f64): the
# 64x16 bench plate with node_disp = planform_shape in y
PLATE64_DIGITS = {"compliance": 4.404894996683404e-03,
                  "grad_node_disp_norm": 2.435319341571109e-04,
                  "grad_thickness_norm": 9.915337844234456e-04,
                  "dir_deriv": -6.416642232958582e-05,
                  "grad_thickness_sum": 2.785668074922315e-02}
KW = dict(dtype=torch.float64)


def _bc(x):
    return x[:, 0] < 1e-12


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


def _node_disp(dy):
    """(n_nodes, 3) mesh motion in y from a (n_nodes,) tensor."""
    z = torch.zeros_like(dy)
    return torch.stack([z, dy, z], dim=1)


def _cantilever(mesh, device="cpu"):
    return RMShellModel(mesh, shell_bc_func=_bc, element_wise_material=True,
                        PENALTY_BC=False, device=device)


def _plate_inputs(nel, nn):
    f = np.zeros(3 * nn)
    f[2::3] = 2.0
    return (f, np.full(nel, 0.2), np.full(nel, 4.32e8), np.zeros(nel),
            np.full(nel, 100.0))


@pytest.fixture(scope="module")
def plate16(ref_env):
    """tests/test_shape_opt.py's 16x4 plate (10 x 2, strong clamp) in both
    packages, its seeded dy0 and the reference's compliance and dy
    gradient there."""
    mesh = createRectangleMesh(16, 4, (0, 0), (10.0, 2.0), "quad", gdim=3)
    ref = RefModel(ref_rect(16, 4, (0, 0), (10.0, 2.0), "quad", gdim=3),
                   shell_bc_func=_bc, element_wise_material=True,
                   PENALTY_BC=False)
    nel, nn = mesh.n_cells, mesh.n_nodes
    args = _plate_inputs(nel, nn)
    rng = np.random.default_rng(0)
    dy0 = 0.02 * rng.standard_normal(nn)
    d = rng.standard_normal(nn)
    d /= np.linalg.norm(d)

    def J(dy):
        nd = jnp.zeros((nn, 3)).at[:, 1].set(dy)
        return jnp.reshape(ref.evaluate(*map(jnp.asarray, args),
                                        node_disp=nd).compliance, ())

    J_r, g_r = jax.value_and_grad(J)(jnp.asarray(dy0))
    return dict(port=_cantilever(mesh), ref=ref, args=args, dy0=dy0, d=d,
                J=float(J_r), g=np.asarray(g_r))


def test_shape_gradient_matches_reference_and_fd(plate16):
    """Compliance and dJ/d(dy) at a random in-plane motion against
    jax.grad, and against a Richardson-extrapolated central difference
    along a random unit direction (the reference test's check)."""
    model, args = plate16["port"], plate16["args"]
    assert model.shell_pde.W.n_dofs <= 6000  # the dense path
    dy = torch.tensor(plate16["dy0"], requires_grad=True)
    out = model.evaluate(*args, node_disp=_node_disp(dy))
    out.compliance.backward()
    assert abs(float(out.compliance) / plate16["J"] - 1.0) <= 1e-10
    assert _rel(dy.grad, plate16["g"]) <= 1e-8

    d = torch.tensor(plate16["d"])

    def fd(eps):
        with torch.no_grad():
            jp, jm = (float(model.evaluate(
                *args, node_disp=_node_disp(dy.detach() + s * eps * d))
                .compliance) for s in (1.0, -1.0))
        return (jp - jm) / (2 * eps)

    fdR = (4.0 * fd(1e-3) - fd(2e-3)) / 3.0
    ad = float(torch.dot(dy.grad, d))
    assert abs(ad - fdR) <= 1e-5 * abs(fdR), (ad, fdR)


def test_flat_node_disp_is_reordered_node_by_node(plate16):
    """A flat (3 n_nodes,) node_disp is the (n_nodes, 3) one, row-major."""
    model, args = plate16["port"], plate16["args"]
    nd = _node_disp(torch.tensor(plate16["dy0"]))
    with torch.no_grad():
        a = model.evaluate(*args, node_disp=nd).compliance
        b = model.evaluate(*args, node_disp=nd.reshape(-1)).compliance
    assert float(a) == float(b)


@pytest.fixture(scope="module")
def plate64():
    mesh = createRectangleMesh(64, 16, (0, 0), (10.0, 2.0), "quad", gdim=3)
    model = _cantilever(mesh)
    assert model.mg is not None and len(model.mg.levels) == 2
    nd0 = np.zeros((mesh.n_nodes, 3))
    nd0[:, 1] = planform_shape(mesh.coords)
    return dict(mesh=mesh, model=model, nd0=nd0,
                args=_plate_inputs(mesh.n_cells, mesh.n_nodes))


class _Counts:
    """Counts the assembler's direct assemblies, basis builds and K2
    combines."""

    def __init__(self, mp):
        self.n = {"direct": 0, "build": 0, "combine": 0}
        for name, owner, attr in (
                ("direct", affine.CachedAffineAssembler, "direct"),
                ("build", affine.AffineDesignOperator, "__init__")):
            mp.setattr(owner, attr, self._wrap(name, getattr(owner, attr)))
        mp.setattr(affine, "_affine_combine",
                   self._wrap("combine", affine._affine_combine))

    def _wrap(self, name, fn):
        def call(*a, **k):
            self.n[name] += 1
            return fn(*a, **k)
        return call

    def take(self):
        n, self.n = self.n, dict.fromkeys(self.n, 0)
        return n


@pytest.fixture(scope="module")
def moved64(plate64):
    """One evaluate + compliance backward of the 64x16 plate at the
    planform change, node_disp and thickness requiring grad, with the
    assembler's work counted."""
    f, th, E, nu, rho = plate64["args"]
    nd = torch.tensor(plate64["nd0"], **KW).requires_grad_(True)
    tht = torch.tensor(th, requires_grad=True)
    with pytest.MonkeyPatch.context() as mp:
        c = _Counts(mp)
        out = plate64["model"].evaluate(f, tht, E, nu, rho, node_disp=nd)
        out.compliance.backward()
    return dict(J=float(out.compliance), g_nd=nd.grad, g_th=tht.grad,
                counts=c.n)


def test_mg_path_matches_pinned_digits(plate64, moved64):
    """64x16 on the MG path: compliance, |dJ/d node_disp|, |dJ/dh|, the
    derivative along planform_direction and sum(dJ/dh) against the JAX
    package's digits."""
    g_nd, g_th = moved64["g_nd"], moved64["g_th"]
    d = torch.tensor(planform_direction(plate64["mesh"].coords))
    got = {"compliance": moved64["J"],
           "grad_node_disp_norm": float(torch.linalg.norm(g_nd)),
           "grad_thickness_norm": float(torch.linalg.norm(g_th)),
           "dir_deriv": float(torch.dot(g_nd[:, 1], d)),
           "grad_thickness_sum": float(g_th.sum())}
    for k, want in PLATE64_DIGITS.items():
        bar = 1e-8 if k == "compliance" else 1e-6
        assert abs(got[k] / want - 1.0) <= bar, (k, got[k], want)


def test_assembler_takes_one_direct_assembly_while_uhat_requires_grad(
        plate64, moved64, plate16):
    """With node_disp requiring grad, the fine operator and the MG level
    are each assembled directly once in the call and no basis is built
    (64x16, MG path). At a fixed geometry without a shape gradient the
    basis is built once, then kept while only the thickness changes: one
    K2 combine per solve (16x4)."""
    assert moved64["counts"] == {"direct": len(plate64["model"].mg.levels),
                                 "build": 0, "combine": 0}
    model, (f, th, E, nu, rho) = plate16["port"], plate16["args"]
    # a geometry no other test has solved at
    nd = _node_disp(torch.tensor(0.5 * plate16["dy0"]))
    with pytest.MonkeyPatch.context() as mp:
        c = _Counts(mp)
        for h in (0.21, 0.22):
            tht = torch.tensor(np.full_like(th, h), requires_grad=True)
            model.evaluate(f, tht, E, nu, rho,
                           node_disp=nd).compliance.backward()
            n = c.take()
            assert n["direct"] == 0
            assert n["build"] == (1 if h == 0.21 else 0)
            if h == 0.22:
                assert n["combine"] == 1


def test_direct_and_basis_assembly_agree(plate16):
    """At one moved geometry the direct assembly (shape gradient asked
    for) and the affine basis combine (not asked for) give the same
    element matrices, and evaluate gives the same compliance and thickness
    gradient either way (16x4, dense path)."""
    model, (f, th, E, nu, rho) = plate16["port"], plate16["args"]
    nd = _node_disp(torch.tensor(plate16["dy0"]))
    p = model.fe_inputs(f, th, E, nu, node_disp=nd)
    emf = model.fea.states["disp_solid"].pde.element_matrices_fn
    with torch.no_grad():
        assert _rel(emf(None, p), emf.direct(None, p)) <= 1e-13
    res = []
    for shape_grad in (True, False):
        # both solves from the zero state: a warm start moves the dense
        # solve's result by its round-off (~1e-11 here)
        model.model._last_states.clear()
        tht = torch.tensor(th, requires_grad=True)
        out = model.evaluate(f, tht, E, nu, rho,
                             node_disp=nd.clone().requires_grad_(shape_grad))
        out.compliance.backward()
        res.append((float(out.compliance), tht.grad))
    # the operators differ by ~4e-16 relative; the dense solve of this
    # system carries that to 1.5e-12 in J and 3.6e-11 in dJ/dh
    assert abs(res[0][0] / res[1][0] - 1.0) <= 1e-11
    assert _rel(res[0][1], res[1][1]) <= 1e-9


def test_aeroelastic_interface_gradients_match_reference(ref_env):
    """ex_aeroelastic_interface.py: a 24x4 penalty-BC plate 3 x 1 under an
    elliptic pressure, node_disp a spanwise stretch; aggregated_stress
    and its gradient in the stretch and in the thickness against the JAX
    package (dense path)."""
    span, chord = 3.0, 1.0
    mesh = StructuredQuadMesh(24, 4, (0, 0), (span, chord), gdim=3)
    rmesh = RefSQM(24, 4, (0, 0), (span, chord), gdim=3)
    nn, nel = mesh.n_nodes, mesh.n_cells
    eta = mesh.coords[:, 0] / span
    pressure = np.zeros((nn, 3))
    pressure[:, 2] = 100.0 * np.sqrt(np.clip(1 - eta ** 2, 0, 1))
    mat = (np.full(nel, 69e9), np.full(nel, 0.33), np.full(nel, 2700.0))
    th0 = 0.02 * (1.0 + 0.1 * np.random.default_rng(8).uniform(size=nel))
    ref = RefModel(rmesh, shell_bc_func=_bc, element_wise_material=True)

    def agg_r(stretch, th):
        nd = jnp.stack([stretch * span * jnp.asarray(eta), jnp.zeros(nn),
                        jnp.zeros(nn)], axis=1)
        out = ref.evaluate(jnp.asarray(pressure), th,
                           *map(jnp.asarray, mat), node_disp=nd)
        return jnp.reshape(out.aggregated_stress, ())

    val_r, (gs_r, gt_r) = jax.value_and_grad(agg_r, argnums=(0, 1))(
        jnp.asarray(0.1), jnp.asarray(th0))
    # the port's side through the module of the script
    # (femo_alpha_tpu_torch/examples/ex_aeroelastic_interface.py)
    ex = ex_aeroelastic_interface.build(device="cpu")
    assert ex["model"].shell_pde.W.n_dofs <= 6000  # the dense path
    stretch = torch.tensor(0.1, **KW).requires_grad_(True)
    th = torch.tensor(th0, requires_grad=True)
    out = ex["evaluate"]({"thickness": th, "stretch": stretch})
    out.aggregated_stress.backward()
    assert abs(float(out.aggregated_stress) / float(val_r) - 1.0) <= 1e-8
    assert abs(float(stretch.grad) / float(gs_r) - 1.0) <= 1e-6
    assert _rel(th.grad, gt_r) <= 1e-6
    assert out.disp_extracted.shape == (nn, 3)


def test_modal_on_a_moved_plate_matches_reference(plate16):
    """evaluate_modal with node_disp (a fixed geometry): the moved 16x4
    plate's eigenvalues against the JAX package's (dense path), and
    modal_eigenvalues at the same geometry."""
    model, ref = plate16["port"], plate16["ref"]
    _, th, E, nu, rho = plate16["args"]
    nd = np.zeros((model.nn, 3))
    nd[:, 1] = plate16["dy0"]
    kw = dict(n_modes=4, solver="dense")
    lam = model.evaluate_modal(th, E, nu, rho, node_disp=nd, **kw)
    lam_r = ref.evaluate_modal(*map(jnp.asarray, (th, E, nu, rho)),
                               node_disp=jnp.asarray(nd), **kw)
    assert _rel(lam.eigenvalues.detach(), lam_r.eigenvalues) <= 1e-12
    flat = model.evaluate_modal(th, E, nu, rho, **kw).eigenvalues
    assert _rel(flat.detach(), lam_r.eigenvalues) > 1e-6
    lam2 = model.modal_eigenvalues(th, E, nu, rho, node_disp=nd, **kw)
    assert _rel(lam2.detach(), lam_r.eigenvalues) <= 1e-12
