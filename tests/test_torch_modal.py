"""Modal analysis and buckling of the port on the CPU, against the JAX
package: RMShellModel.evaluate_modal / modal_eigenvalues (dense reduced
eigh and LOBPCG), the J(uhat) inertia form, the Rayleigh-quotient
eigenvalue gradients, the penalty-BC case, three SLSQP iterations of the
frequency-constrained example and the handbook buckling formulas.

Inputs are made with numpy from a seed (tests/test_modal.py::_setup's
8x4 plate). The model-level cases hold the port to the JAX package's
results at these inputs pinned in tests/reference_digits/modal_8x4.npz
by `tools/modal_reference_digits.py tests` (the live JAX calls took
~125 s); the form, dense-helper and buckling cases call the JAX package
live. f64 throughout; the reference runs with its FEMO_* solver flags
unset (FEMO_MG_F32, FEMO_LANE_MAJOR, FEMO_HOSTLOOP, FEMO_CG_DF,
FEMO_OP_STORAGE). The SLSQP trajectory depends on scipy's version, which
the file records (1.17.0). Tolerances: 1e-12 relative
for the dense eigenvalues and the forms (the same arithmetic in another
order), 1e-10 for LOBPCG against the dense path and against the
reference's LOBPCG from the same start block (Ritz values converge as the
residual squared), 1e-8 for eigenvalue gradients and the SLSQP history,
1e-14 for the buckling formulas."""

import os

import numpy as np
import pytest
import scipy
import torch

import jax
import jax.numpy as jnp

from femo_alpha_tpu.assembly.assemble import assemble_scalar as ref_scalar
from femo_alpha_tpu.assembly.assemble import element_matrices as ref_elmat
from femo_alpha_tpu.mesh import createRectangleMesh as ref_rect
from femo_alpha_tpu.models.rm_shell import buckling as ref_bk
from femo_alpha_tpu.models.rm_shell.pde import RMShellPDE as RefPDE
from femo_alpha_tpu.solvers.direct import apply_bc_dense as ref_bc_dense
from femo_alpha_tpu.solvers.direct import dense_from_elements as ref_dense

from femo_alpha_tpu_torch.assembly.assemble import assemble_scalar
from femo_alpha_tpu_torch.assembly.assemble import element_matrices
from femo_alpha_tpu_torch.mesh import createRectangleMesh
from femo_alpha_tpu_torch.models import RMShellModel
from femo_alpha_tpu_torch.models.rm_shell import buckling as bk
from femo_alpha_tpu_torch.solvers.direct import (
    apply_bc_dense,
    dense_from_elements,
)

REF_FLAGS = ("FEMO_MG_F32", "FEMO_LANE_MAJOR", "FEMO_HOSTLOOP", "FEMO_CG_DF",
             "FEMO_OP_STORAGE")
REF_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "reference_digits", "modal_8x4.npz")


def _bc(x):
    return x[:, 0] < 1e-12


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _inputs(nel, seed=3):
    """tests/test_modal.py::_setup's material, density as a field."""
    rng = np.random.default_rng(seed)
    th = 0.02 + 0.01 * rng.random(nel)
    E = 7.0e10 * (1.0 + 0.1 * rng.random(nel))
    return th, E, np.full(nel, 0.3), np.full(nel, 2700.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: the tests run
    beside other workers, and multithreaded f64 triangular solves and
    einsums at these sizes are many times slower than one thread."""
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


@pytest.fixture(scope="module")
def ref():
    """The JAX package's results at this file's inputs
    (tools/modal_reference_digits.py tests)."""
    with np.load(REF_NPZ) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def plate(ref_env):
    """The 8x4 plate (2 x 1), strong clamp at x = 0, element-wise
    material; the reference's RMShellPDE on the same mesh."""
    mesh = createRectangleMesh(8, 4, (0, 0), (2.0, 1.0), "quad", gdim=3)
    rmesh = ref_rect(8, 4, (0, 0), (2.0, 1.0), "quad", gdim=3)
    port = RMShellModel(mesh, shell_bc_func=_bc, element_wise_material=True,
                        PENALTY_BC=False, device="cpu")
    return dict(port=port, ref_pde=RefPDE(rmesh, element_wise_material=True),
                args=_inputs(mesh.n_cells))


@pytest.fixture(scope="module")
def dense(plate):
    return plate["port"].evaluate_modal(*plate["args"], n_modes=5,
                                        solver="dense")


def test_dense_eigenvalues_match_reference(dense, ref):
    """The assembled K and M reduced to the free dofs, then the Cholesky-
    reduced eigh: eigenvalues to 1e-12, frequencies and extracted modes
    (up to sign) beside them."""
    port = dense
    lam, lam_r = port.eigenvalues.detach(), ref["dense_eigenvalues"]
    assert _rel(lam, lam_r) <= 1e-12
    assert _rel(port.frequencies.detach(), ref["dense_frequencies"]) <= 1e-12
    torch.testing.assert_close(port.frequencies.detach(),
                               torch.sqrt(lam) / (2 * np.pi), rtol=1e-15,
                               atol=0)
    mx, mx_r = port.modes_extracted, ref["dense_modes_extracted"]
    assert mx.shape == mx_r.shape
    for i in range(5):
        s = float(np.sign(np.vdot(mx[i].numpy(), mx_r[i])))
        assert _rel(s * mx[i].numpy(), mx_r[i]) <= 1e-8


def test_lobpcg_matches_dense_and_reference(plate, dense, ref):
    """LOBPCG (the dense solve path's Cholesky as preconditioner) from
    default_rng(seed)'s start block: eigenvalues to 1e-10 of the port's
    dense path and of the reference's LOBPCG from the same block; the
    residual norms <= 1e-5; the modes M-orthonormal."""
    args = plate["args"]
    kw = dict(n_modes=4, solver="lobpcg", tol=1e-10, maxiter=100, seed=0)
    port = plate["port"].evaluate_modal(*args, **kw)
    lam = port.eigenvalues.detach()
    assert _rel(lam, dense.eigenvalues.detach()[:4]) <= 1e-10
    assert _rel(lam, ref["lobpcg_eigenvalues"]) <= 1e-10
    assert float(port.res_norms.max()) <= 1e-5
    assert 0 < port.iterations < 100
    model = plate["port"]
    _, mp = model._modal_fe_params()(*[torch.as_tensor(a) for a in args])
    Me = model._modal_mass()[1](None, mp).permute(2, 0, 1)
    Md = dense_from_elements(Me, model.shell_pde.W.dofmap,
                             model.shell_pde.W.n_dofs)
    X = port.modes
    G = X.T @ Md @ X
    assert float((G - torch.eye(4, dtype=G.dtype)).abs().max()) <= 1e-8


def test_eigenvalue_gradient_matches_reference(plate, ref):
    """modal_eigenvalues(n_modes=1): the backward of the Rayleigh quotient
    at the converged mode against jax.grad of the reference's Rayleigh map
    at its own converged modes (what its modal_eigenvalues differentiates),
    in thickness, E, nu and density, to 1e-8; the memo serves a repeated
    design point."""
    args = plate["args"]
    model = plate["port"]
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in args]
    lam = model.modal_eigenvalues(*leaves, n_modes=1)[0]
    lam.backward()
    g_r = [ref[f"grad_{k}"] for k in ("thickness", "E", "nu", "density")]
    for t, g in zip(leaves, g_r):
        assert _rel(t.grad, g) <= 1e-8
    n_cached = len(model._modal_modes_cache)
    again = model.modal_eigenvalues(*[torch.as_tensor(a) for a in args],
                                    n_modes=1)
    assert len(model._modal_modes_cache) == n_cached
    assert float(again[0]) == float(lam.detach())


def test_penalty_bc_modal_matches_reference(plate, ref):
    """The penalty-BC model (the reference's default BC mode) on the same
    plate, LOBPCG on the dense solve path, against the reference's run
    from the same start block: eigenvalues to 1e-10."""
    mesh = plate["port"].mesh
    args = plate["args"]
    kw = dict(n_modes=3, solver="lobpcg", tol=1e-10)
    port = RMShellModel(mesh, shell_bc_func=_bc, element_wise_material=True,
                        device="cpu").evaluate_modal(*args, **kw)
    assert _rel(port.eigenvalues.detach(),
                ref["penalty_eigenvalues"]) <= 1e-10


def test_inertia_form_with_uhat_matches_reference(plate):
    """inertia_form(with_uhat=True) under a mesh motion uhat (the J(uhat)
    pullback): element matrices to 1e-12."""
    pde, rpde = plate["port"].shell_pde, plate["ref_pde"]
    rng = np.random.default_rng(1)
    nel = pde.mesh.n_cells
    p = {"thickness": 0.02 + 0.01 * rng.random(nel),
         "density": 2700.0 * (1 + 0.1 * rng.random(nel)),
         "uhat": 1e-2 * rng.standard_normal(pde.VU.n_dofs)}
    zero = np.zeros(pde.W.n_dofs)
    Me = element_matrices(pde.inertia_form(with_uhat=True),
                          torch.as_tensor(zero),
                          {k: torch.as_tensor(v) for k, v in p.items()})
    Me_r = ref_elmat(rpde.inertia_form(with_uhat=True), jnp.asarray(zero),
                     {k: jnp.asarray(v) for k, v in p.items()})
    assert _rel(Me, Me_r) <= 1e-12
    u = 1e-3 * rng.standard_normal(pde.W.n_dofs)
    e = assemble_scalar(pde.inertia_form(with_uhat=True), torch.as_tensor(u),
                        {k: torch.as_tensor(v) for k, v in p.items()})
    e_r = ref_scalar(rpde.inertia_form(with_uhat=True), jnp.asarray(u),
                     {k: jnp.asarray(v) for k, v in p.items()})
    assert abs(float(e) / float(e_r) - 1.0) <= 1e-12
    # the dense helpers on these element matrices
    n = pde.W.n_dofs
    A = dense_from_elements(Me, pde.W.dofmap, n)
    A_r = ref_dense(Me_r, jnp.asarray(rpde.W.dofmap), n)
    assert _rel(A, A_r) <= 1e-12
    f = (rng.random(n) > 0.2).astype(np.float64)
    assert _rel(apply_bc_dense(A, torch.as_tensor(f)),
                ref_bc_dense(A_r, jnp.asarray(f))) <= 1e-12


def test_frequency_constrained_opt_history_matches_reference(ref):
    """Three SLSQP iterations of the frequency-constrained study of
    examples/advanced_examples/modal_analysis/ex_frequency_constrained_opt.py
    (its 2 x 1 plate clamped at x = 0, min mass s.t. a 20 % higher
    fundamental frequency, h in [h0/2, 3 h0] from h0 = 0.01, E 7e10,
    nu 0.3, rho 2700) on the 8x4 mesh of the models above, built by the
    port's module of the script
    (femo_alpha_tpu_torch/examples/ex_frequency_constrained_opt.py): the
    objective at each iteration to 1e-8 and the same nit / nfev / njev as
    the reference's run (jitted, its eigensolve warmed per design point,
    as its own jitted test runs it), on the scipy it ran with."""
    from femo_alpha_tpu_torch.examples import ex_frequency_constrained_opt

    assert scipy.__version__ == str(ref["scipy_version"])
    ex = ex_frequency_constrained_opt.build(nx=8, ny=4, device="cpu")
    prob = ex["problem"]
    _, res = prob.solve(maxiter=3, ftol=1e-8, report=False)
    hist_r = ref["opt_history"]
    assert len(prob.history) == len(hist_r) == 3
    assert _rel(prob.history, hist_r) <= 1e-8
    assert [res.nit, res.nfev, res.njev] == ref["opt_counts"].tolist()
    # one evaluation per design point
    assert prob.counts["evaluate"] == res.nfev


def test_buckling_matches_reference():
    """The handbook formulas and the bay margin against the reference's, on
    floats and tensors, and their autograd gradient against jax.grad, to
    1e-14."""
    E, nu = 69e9, 0.33
    corners = np.array([[0.0, 0.0, 0.0], [0.4, 0.0, 0.0],
                        [0.0, 0.5, 0.05], [0.4, 0.55, 0.05]])
    for ar in (0.25, 0.55, 1.0, 1.47, 2.6, 7.0):
        assert bk.compression_k(ar) == ref_bk.compression_k(ar)
        assert bk.shear_k(ar) == ref_bk.shear_k(ar)
    np.testing.assert_allclose(bk.bay_dimensions(corners),
                               ref_bk.bay_dimensions(corners), rtol=1e-14)
    for t in (0.002, 0.004):
        pairs = [
            (bk.flat_plate_sigma_cr(E, nu, t, 0.35, 1.2),
             ref_bk.flat_plate_sigma_cr(E, nu, t, 0.35, 1.2)),
            (bk.flat_plate_tau_cr(E, nu, t, 0.35, 0.7),
             ref_bk.flat_plate_tau_cr(E, nu, t, 0.35, 0.7)),
            (bk.curved_panel_sigma_cr(E, nu, t, 0.4, 0.8),
             ref_bk.curved_panel_sigma_cr(E, nu, t, 0.4, 0.8)),
            (bk.curved_panel_sigma_cr(
                E, nu, torch.tensor(t, dtype=torch.float64), 0.4, 0.8),
             ref_bk.curved_panel_sigma_cr(E, nu, t, 0.4, 0.8)),
            (bk.bay_buckling_margins(40e6, 10e6, E, nu,
                                     torch.tensor(t, dtype=torch.float64),
                                     corners, knockdown=1.5),
             ref_bk.bay_buckling_margins(40e6, 10e6, E, nu, t, corners,
                                         knockdown=1.5)),
        ]
        for got, want in pairs:
            assert abs(float(got) / float(want) - 1.0) <= 1e-14

    def margin(mod, t):
        return mod.bay_buckling_margins(40e6, 10e6, E, nu, t, corners,
                                        knockdown=1.5)

    def curved(mod, t):
        return mod.curved_panel_sigma_cr(E, nu, t, 0.4, 0.8)

    for fn in (margin, curved):
        t = torch.tensor(0.003, dtype=torch.float64, requires_grad=True)
        fn(bk, t).backward()
        g_r = float(jax.grad(lambda x: fn(ref_bk, x))(0.003))
        assert abs(float(t.grad) / g_r - 1.0) <= 1e-14
