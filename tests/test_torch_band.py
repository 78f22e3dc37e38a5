"""The port's band Cholesky (femo_alpha_tpu_torch/solvers/band.py) on the
CPU, against the JAX package: the RCM ordering and bandwidth, the blocked
factor and solve against dense Cholesky, the preconditioner on a penalty
wing, and RMShellModel above the dense cutoff, where both packages solve
through band-preconditioned CG.

Inputs are made with numpy from a seed; f64 throughout. The RCM order,
the dof permutation and the band are compared with the JAX package's
live (host numpy); its band apply and its model at the same inputs are
pinned in tests/reference_digits/wing.npz by
`tools/wing_reference_digits.py tests` (the JAX package with its FEMO_*
solver flags unset: FEMO_MG_F32, FEMO_LANE_MAJOR, FEMO_HOSTLOOP,
FEMO_CG_DF, FEMO_OP_STORAGE, FEMO_BAND_MEM_GB; with
FEMO_COMPILE_CACHE=0)."""

import os

import numpy as np
import pytest
import torch

from femo_alpha_tpu.mesh import createWingShellMesh as ref_wing
from femo_alpha_tpu.mesh import readFEAMesh as ref_read
from femo_alpha_tpu.models.rm_shell.pde import RMShellPDE as RefPDE
from femo_alpha_tpu.native import rcm_order as ref_rcm
from femo_alpha_tpu.solvers import band as RB

from femo_alpha_tpu_torch.assembly.assemble import element_matrices
from femo_alpha_tpu_torch.mesh import createWingShellMesh, readFEAMesh
from femo_alpha_tpu_torch.models import RMShellModel
from femo_alpha_tpu_torch.models.rm_shell.pde import RMShellPDE
from femo_alpha_tpu_torch.native import rcm_order
from femo_alpha_tpu_torch.solvers import band as B

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
REF_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "reference_digits", "wing.npz")


@pytest.fixture(scope="module")
def ref():
    with np.load(REF_NPZ) as z:
        return {k: z[k] for k in z.files}


def _root(x):
    return np.abs(x[:, 1]) < 1e-9


@pytest.mark.parametrize("name", ["pav_like_wing_2388.msh",
                                  "c172_like_wing_648.msh", "wing_6x10"])
def test_rcm_and_bandwidth_match_reference(name):
    """The same node ordering as the reference's native RCM, hence the same
    dof permutation and band (PAV wing: b = 2,111)."""
    if name == "wing_6x10":
        mesh = createWingShellMesh(6, 10, rib_stations=(5,))
        ref_mesh = ref_wing(6, 10, rib_stations=(5,))
    else:
        mesh = readFEAMesh(os.path.join(DATA, name))
        ref_mesh = ref_read(os.path.join(DATA, name))
    mesh._build_topology()
    ref_mesh._build_topology()
    np.testing.assert_array_equal(rcm_order(mesh.edges, mesh.n_nodes),
                                  ref_rcm(ref_mesh.edges, ref_mesh.n_nodes))
    pde = RMShellPDE(mesh, element_wise_material=True, device="cpu")
    ref = RefPDE(ref_mesh, element_wise_material=True)
    perm, iperm = B.nodal_dof_permutation(pde.W)
    ref_perm, ref_iperm = RB.nodal_dof_permutation(ref.W)
    np.testing.assert_array_equal(perm, ref_perm)
    np.testing.assert_array_equal(iperm, ref_iperm)
    b = B.permuted_bandwidth(iperm, [pde.W.dofmap])
    assert b == RB.permuted_bandwidth(ref_iperm, [np.asarray(ref.W.dofmap)])
    if name.startswith("pav"):
        assert (b, B.pick_block(b, pde.W.n_dofs)) == (2111, 128)


def _spd_band(rng, n, bw):
    A = np.zeros((n, n))
    for i in range(n):
        for j in range(max(0, i - bw), i + 1):
            A[i, j] = 0.1 * rng.standard_normal()
    A = A + A.T
    return A + np.eye(n) * (np.abs(A).sum(axis=1).max() + 1.0)


def _band_of(A, w, m):
    n = A.shape[0]
    nb = -(-n // w)
    K = (m + 1) * w
    slots, inv = B.band_assembly_plan([np.arange(n)[None]], np.arange(n), n,
                                      w, m)
    rows = np.arange(nb * w)[n:]
    fill = (rows // w) * (w * K) + (rows % w) * K + m * w + rows % w
    return B.assemble_block_band(
        [torch.as_tensor(A[:, :, None])], torch.as_tensor(slots),
        torch.as_tensor(inv), torch.as_tensor(fill), nb, w, K)


@pytest.mark.parametrize("n,bw,w,m", [(37, 5, 8, 1), (100, 20, 8, 3),
                                      (20, 5, 8, 4)])
def test_band_factor_matches_dense(n, bw, w, m):
    """Blocked band Cholesky + solve == dense solve of the equilibrated
    system to 1e-12 (as tests/test_band.py:18 holds the reference); the
    last case has fewer block rows than the window (nb < m + 1)."""
    rng = np.random.default_rng(n)
    A = _spd_band(rng, n, bw)
    R = _band_of(A, w, m)
    s = B.equilibrate(R, w, m).numpy()
    Ld, Lc = B.band_cholesky(R, w, m)
    b = rng.standard_normal(len(s))
    x = B.band_solve(Ld, Lc, torch.as_tensor(b)).numpy()
    Apad = np.eye(len(s))
    Apad[:n, :n] = A
    assert np.abs(x - np.linalg.solve(Apad * s[:, None] * s[None, :],
                                      b)).max() < 1e-12


def test_band_factor_raises_when_not_positive_definite():
    A = _spd_band(np.random.default_rng(0), 24, 4)
    A[10, 10] = -A[10, 10]
    with pytest.raises(RuntimeError, match="not positive definite"):
        B.band_cholesky(_band_of(A, 8, 1), 8, 1)


def test_band_precond_on_penalty_wing_matches_reference(ref):
    """On the 6x10 penalty wing (cell block + facet block): two assemblies
    bit for bit, the apply a direct solve (rel res 1e-9, as
    tests/test_band.py holds the reference), and the port's
    BandCholPrecond.apply against the reference's f64 one to 1e-8. Not
    1e-10: the penalty system's condition number is 1.4e12 here, and two
    backward-stable f64 factorizations of the SAME element matrices (the
    reference's fed the port's) differ by 7.7e-10 on this random rhs, as
    numpy's dense solve differs from the port's by 1.1e-9."""
    mesh = createWingShellMesh(6, 10, rib_stations=(5,))
    pde = RMShellPDE(mesh, element_wise_material=True, device="cpu")
    nel, nn, n = mesh.n_cells, mesh.n_nodes, pde.W.n_dofs
    rng = np.random.default_rng(3)
    p = {"thickness": 0.01 * (1 + 0.2 * rng.uniform(size=nel)),
         "E": np.full(nel, 7e10), "nu": np.full(nel, 0.33),
         "uhat": np.zeros(3 * nn), "F_solid": np.zeros(3 * nn)}
    b = rng.standard_normal(n)

    ff = pde.make_penalty_facet_form(_root)
    pt = {k: torch.as_tensor(v) for k, v in p.items()}
    u0 = torch.zeros(n, dtype=torch.float64)
    ops = [element_matrices(pde.make_residual_form(), u0, pt)
           .permute(1, 2, 0).contiguous(), ff.element_ops(u0, pt)]
    band = B.BandCholPrecond(pde.W, [pde.W.dofmap, ff.block.dofmap])
    R1, R2 = band.assemble(ops), band.assemble(ops)
    assert torch.equal(R1, R2)
    x = band.apply(band.factor(R1), torch.as_tensor(b)).numpy()
    x_ref = ref["band_apply"]
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) <= 1e-8

    from femo_alpha_tpu_torch.solvers.linear import dense_from_blocks

    A = dense_from_blocks(list(zip(ops, [pde.W, ff.block])), n).numpy()
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) <= 1e-9


# ------------------------------------------- the model above the dense cutoff
KW = dict(n_chord=8, n_span=36, rib_stations=(18,))


def _model_inputs(nel, nn):
    rng = np.random.default_rng(4)
    f = np.zeros(3 * nn)
    f[2::3] = 50.0 * (1.0 + 0.1 * rng.standard_normal(nn))
    th = 0.02 * (1.0 + 0.2 * rng.uniform(size=nel))
    return f, th, np.full(nel, 7e10), np.full(nel, 0.33), np.full(nel, 2700.)


@pytest.fixture(scope="module")
def band_reference(ref):
    """The JAX package on the 8x36 wing (8,823 dofs, band-preconditioned
    CG): disp_solid and d compliance / d thickness (pinned)."""
    return ref["band_model_u"], ref["band_model_grad"]


def test_band_model_matches_reference(band_reference):
    u_ref, g_ref = band_reference
    mesh = createWingShellMesh(**KW)
    model = RMShellModel(mesh, shell_bc_func=_root,
                         element_wise_material=True, device="cpu")
    assert model.shell_pde.W.n_dofs > 6000
    assert model.band.b > 0  # the band path
    f, th, E, nu, rho = _model_inputs(mesh.n_cells, mesh.n_nodes)

    def J(th_):
        return model.evaluate(f, th_, E, nu, rho)

    tt = torch.tensor(th, requires_grad=True)
    out = J(tt)
    u = out.disp_solid.detach().numpy()
    assert np.linalg.norm(u - u_ref) / np.linalg.norm(u_ref) <= 1e-8
    out.compliance.backward()
    g = tt.grad.numpy()
    assert np.linalg.norm(g - g_ref) / np.linalg.norm(g_ref) <= 1e-6
    # central difference along a seeded direction; the step keeps the FD
    # noise from the solve's ~1e-8 residual floor below truncation error
    d = np.random.default_rng(5).standard_normal(mesh.n_cells)
    eps = 1e-5
    with torch.no_grad():
        fd = (float(J(torch.as_tensor(th + eps * d)).compliance)
              - float(J(torch.as_tensor(th - eps * d)).compliance)) / (2 * eps)
    assert abs(fd - g @ d) <= 1e-4 * abs(fd)
