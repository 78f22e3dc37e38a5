"""Tests of femo_alpha_tpu_torch that need a CUDA card: the Hopper kernels
against their plain twins (the fused constrained operator at the slice's
two smoothed-level shapes, and bit for bit from run to run; K2 at K = 1..4
on even, odd and misaligned inputs, and bit for bit), the launch
counters, the card as the default device, the slice on the card
against the same slice on the CPU, and the default aircraft configuration:
the band Cholesky factor on the card against the CPU path, and a penalty
wing model on the card against the same model on the CPU; the transient
shell (PlateSim, MG) on the card against the CPU, its checkpointed
segments recomputed bit for bit and its V-cycle setup repeated bit for
bit; modal analysis (LOBPCG + MG) on the card against the CPU, and
OptimizationProblem and the csdl operations on the card by default; the
PAV wing's evaluate and stress backward bit for bit from one fresh model
to the next, and the indexed gathers' backward bit for bit; a moved
plate's evaluate and shape backward on the card against the CPU and bit
for bit; the AMG's Schwarz apply through K1 against the twin, and AMG
setups and applies bit for bit. They skip without a card. The
file imports no jax, so on a machine without the JAX package it runs on
its own:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest
"""

import os

import numpy as np
import pytest
import torch

from femo_alpha_tpu_torch.assembly import cuda_kernels as ck
from femo_alpha_tpu_torch.assembly.assemble import make_constrained_matvec_T
from femo_alpha_tpu_torch.assembly.bc import DirichletBC, combine_bcs
from femo_alpha_tpu_torch.mesh import createRectangleMesh
from femo_alpha_tpu_torch.models import RMShellModel
from femo_alpha_tpu_torch.models.rm_shell.mg import strong_bc_dofs
from femo_alpha_tpu_torch.models.rm_shell.pde import RMShellPDE

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _clamped(x):
    return x[:, 0] < 1e-12


def _rect(nx, ny):
    return createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad", gdim=3)


def _shell_operator(gen, nx, ny, dtype):
    """Seeded Ae and x on the shell's mixed space of an nx x ny plate, with
    its clamped-edge mask: (fused operator, plain twin, x)."""
    pde = RMShellPDE(_rect(nx, ny), element_wise_material=True,
                     device="cuda")
    W = pde.W
    free, _ = combine_bcs(W.n_dofs,
                          [DirichletBC(strong_bc_dofs(pde, _clamped))],
                          dtype=dtype, device="cuda")
    Ae = torch.randn((W.nd_local, W.nd_local, nx * ny), generator=gen,
                     device="cuda", dtype=dtype)
    x = torch.randn((W.n_dofs,), generator=gen, device="cuda", dtype=dtype)
    dofmap_T, inv = W.lane_tables(Ae.device)

    def plain(v):
        return ck.constrained_matvec_T_plain(Ae, v, free, dofmap_T, inv)

    return make_constrained_matvec_T(Ae, W, free), plain, x


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-14)])
@pytest.mark.parametrize("nd,nc", [(39, 4096), (12, 1000), (3, 65536)])
def test_k1_matches_twin(cuda, dtype, bar, nd, nc):
    A = torch.randn((nd, nd, nc), generator=cuda, device="cuda", dtype=dtype)
    x = torch.randn((nd, nc), generator=cuda, device="cuda", dtype=dtype)
    assert _rel(ck.cell_matvec_T(A, x), ck.cell_matvec_T_plain(A, x)) <= bar


K2_POWERS = [(1,), (1, 3), (1, 2, 3), (0, 1, 2, 3)]


def _k2_inputs(gen, powers, nc, dtype, offset=0):
    """A seeded basis (K, 39, 39, nc), as a view `offset` elements into its
    buffer (offset 1 is off 16-byte alignment: the scalar instance), and
    theta in [0.1, 0.3]."""
    n = len(powers) * 39 * 39 * nc
    flat = torch.randn((n + offset,), generator=gen, device="cuda",
                       dtype=dtype) * 1e3
    th = 0.1 + 0.2 * torch.rand((nc,), generator=gen, device="cuda",
                                dtype=dtype)
    return flat[offset:].view(len(powers), 39, 39, nc), th


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-15)])
@pytest.mark.parametrize("powers", K2_POWERS)
@pytest.mark.parametrize("nc,offset", [(800, 0), (801, 0), (2388, 0),
                                       (4096, 0), (800, 1)])
def test_k2_matches_twin(cuda, dtype, bar, powers, nc, offset):
    B, th = _k2_inputs(cuda, powers, nc, dtype, offset)
    out = ck.affine_combine(B, th, powers)
    assert out.shape == (39, 39, nc) and out.dtype == dtype
    assert _rel(out, ck.affine_combine_plain(B, th, powers)) <= bar


@pytest.mark.parametrize("nc,offset", [(2388, 0), (801, 0), (800, 1)])
def test_k2_is_bitwise_repeatable(cuda, nc, offset):
    for powers in K2_POWERS:
        B, th = _k2_inputs(cuda, powers, nc, torch.float64, offset)
        assert torch.equal(ck.affine_combine(B, th, powers),
                           ck.affine_combine(B, th, powers))


def test_k2_backward_matches_twin_autograd(cuda):
    B = torch.randn((2, 39, 39, 256), generator=cuda, device="cuda",
                    dtype=torch.float64)
    th = 0.1 + 0.2 * torch.rand((256,), generator=cuda, device="cuda",
                                dtype=torch.float64)
    G = torch.randn((39, 39, 256), generator=cuda, device="cuda",
                    dtype=torch.float64)
    t1 = th.clone().requires_grad_(True)
    (g1,) = torch.autograd.grad(ck.affine_combine(B, t1, (1, 3)), t1, G)
    t2 = th.clone().requires_grad_(True)
    (g2,) = torch.autograd.grad(ck.affine_combine_plain(B, t2, (1, 3)), t2,
                                G)
    assert _rel(g1, g2) <= 1e-12


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-14)])
@pytest.mark.parametrize("nx,ny", [(128, 32), (64, 16)])
def test_fused_operator_matches_twin(cuda, dtype, bar, nx, ny):
    op, plain, x = _shell_operator(cuda, nx, ny, dtype)
    y = op(x)
    assert y.dtype == dtype and y.shape == x.shape
    assert _rel(y, plain(x)) <= bar


@pytest.mark.parametrize("nx,ny", [(128, 32), (64, 16), (5, 3)])
def test_fused_operator_f32_matrices_f64_vectors(cuda, nx, ny):
    """The fused operator's f32-matrix, f64-vector build (the operator
    under storage="f32"): f64 out, and bit for bit the f64 build on the
    matrices upcast (odd nc takes the unvectorized cell pass)."""
    op64, _, x = _shell_operator(cuda, nx, ny, torch.float64)
    pde = RMShellPDE(_rect(nx, ny), element_wise_material=True,
                     device="cuda")
    free, _ = combine_bcs(pde.W.n_dofs,
                          [DirichletBC(strong_bc_dofs(pde, _clamped))],
                          dtype=torch.float64, device="cuda")
    A32 = torch.randn((pde.W.nd_local, pde.W.nd_local, nx * ny),
                      generator=cuda, device="cuda").float()
    y = make_constrained_matvec_T(A32, pde.W, free)(x)
    y64 = make_constrained_matvec_T(A32.double(), pde.W, free)(x)
    assert y.dtype == torch.float64 and torch.equal(y, y64)


def test_fused_operator_is_bitwise_repeatable(cuda):
    op, _, x = _shell_operator(cuda, 128, 32, torch.float64)
    assert torch.equal(op(x), op(x))


def test_fused_operator_refuses_bad_vectors(cuda):
    op, _, x = _shell_operator(cuda, 64, 16, torch.float64)
    for bad in (x[1:], x.float(), x.cpu(), x.repeat(2)[::2]):
        with pytest.raises(ValueError):
            op(bad)


def test_model_defaults_to_the_card(cuda):
    model = RMShellModel(_rect(64, 16), shell_bc_func=_clamped,
                         element_wise_material=True, PENALTY_BC=False)
    assert model.device.type == "cuda"
    assert model.fea.states["disp_solid"].pde.free_mask.is_cuda


def test_launches_are_counted(cuda):
    A = torch.randn((3, 3, 100), generator=cuda, device="cuda",
                    dtype=torch.float64)
    x = torch.randn((3, 100), generator=cuda, device="cuda",
                    dtype=torch.float64)
    op, plain, v = _shell_operator(cuda, 64, 16, torch.float64)
    ck.reset_launch_counts()
    ck.cell_matvec_T(A, x)
    ck.affine_combine(A[None], x[0], (1,))
    ck.cell_matvec_T_plain(A, x)
    op(v)
    plain(v)
    assert ck.launch_counts() == {"cell_matvec_T": 1, "affine_combine": 1,
                                  "constrained_matvec_T": 1}


def test_slice_on_card_matches_cpu(cuda):
    mesh = _rect(64, 16)
    res = {}
    for dev in ("cpu", "cuda"):
        model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 0] < 1e-12,
                             element_wise_material=True, PENALTY_BC=False,
                             device=dev)
        kw = dict(dtype=torch.float64, device=dev)
        f = torch.zeros(3 * mesh.n_nodes, **kw)
        f[2::3] = 2.0
        th = torch.full((mesh.n_cells,), 0.2, **kw).requires_grad_(True)
        if dev == "cpu":
            # card tensors into a CPU-built model raise, never move
            with pytest.raises(ValueError, match="device="):
                model.evaluate(f.cuda(), th.detach().cuda(),
                               torch.full_like(th, 4.32e8).detach().cuda(),
                               torch.zeros_like(th).detach().cuda(),
                               torch.full_like(th, 100.0).detach().cuda())
        ck.reset_launch_counts()
        out = model.evaluate(f, th, torch.full_like(th, 4.32e8).detach(),
                             torch.zeros_like(th).detach(),
                             torch.full_like(th, 100.0).detach())
        out.compliance.backward()
        launched = ck.launch_counts()
        res[dev] = (float(out.compliance.detach()),
                    out.disp_solid.detach().cpu(), th.grad.cpu(), launched)
    assert res["cpu"][3] == {"cell_matvec_T": 0, "affine_combine": 0,
                             "constrained_matvec_T": 0}
    # the solve path runs the fused operator, never the standalone K1
    assert res["cuda"][3]["constrained_matvec_T"] > 0
    assert res["cuda"][3]["affine_combine"] > 0
    assert res["cuda"][3]["cell_matvec_T"] == 0
    Jc, Jg = res["cpu"][0], res["cuda"][0]
    assert abs(Jc - Jg) <= 1e-9 * Jc
    assert _rel(res["cuda"][1], res["cpu"][1]) <= 1e-8
    assert _rel(res["cuda"][2], res["cpu"][2]) <= 1e-7
    assert np.isfinite(res["cuda"][2].numpy()).all()


def _spd_band(rng, n, bw):
    A = np.zeros((n, n))
    for i in range(n):
        for j in range(max(0, i - bw), i + 1):
            A[i, j] = 0.1 * rng.standard_normal()
    A = A + A.T
    return A + np.eye(n) * (np.abs(A).sum(axis=1).max() + 1.0)


def test_band_factor_on_card_matches_cpu(cuda):
    """The band assembled, factored and applied on the card against the
    same on the CPU: a well-conditioned synthetic band to 1e-12, and on the
    6x10 penalty wing (condition ~1e12) the factors to 1e-10 and the apply
    to 1e-8; two factors on the card bit for bit."""
    from femo_alpha_tpu_torch.assembly.assemble import element_matrices
    from femo_alpha_tpu_torch.mesh import createWingShellMesh
    from femo_alpha_tpu_torch.solvers import band as B

    rng = np.random.default_rng(0)
    n, w, m = 300, 32, 2
    A = _spd_band(rng, n, 40)
    b = rng.standard_normal(n)
    plan = B.band_assembly_plan([np.arange(n)[None]], np.arange(n), n, w, m)
    xs = {}
    for dev in ("cpu", "cuda"):
        slots, inv = (torch.as_tensor(a, device=dev) for a in plan)
        fill = torch.as_tensor(np.arange(n, 320) // w * (w * 96)
                               + np.arange(n, 320) % w * 97 + m * w,
                               device=dev)
        R = B.assemble_block_band(
            [torch.as_tensor(A[:, :, None], device=dev)], slots, inv, fill,
            10, w, 96)
        s_ = B.equilibrate(R, w, m)
        Ld, Lc = B.band_cholesky(R, w, m)
        bp = torch.zeros(320, dtype=torch.float64, device=dev)
        bp[:n] = torch.as_tensor(b, device=dev)
        xs[dev] = (B.band_solve(Ld, Lc, bp * s_) * s_)[:n].cpu().numpy()
    assert np.abs(xs["cuda"] - np.linalg.solve(A, b)).max() <= 1e-12 * \
        np.abs(xs["cpu"]).max()

    mesh = createWingShellMesh(6, 10, rib_stations=(5,))
    res = {}
    for dev in ("cpu", "cuda"):
        pde = RMShellPDE(mesh, element_wise_material=True, device=dev)
        ff = pde.make_penalty_facet_form(lambda x: np.abs(x[:, 1]) < 1e-9)
        kw = dict(dtype=torch.float64, device=dev)
        nel, nn, nd = mesh.n_cells, mesh.n_nodes, pde.W.n_dofs
        p = {"thickness": torch.full((nel,), 0.01, **kw),
             "E": torch.full((nel,), 7e10, **kw),
             "nu": torch.full((nel,), 0.33, **kw),
             "uhat": torch.zeros(3 * nn, **kw),
             "F_solid": torch.zeros(3 * nn, **kw)}
        u0 = torch.zeros(nd, **kw)
        ops = [element_matrices(pde.make_residual_form(), u0, p)
               .permute(1, 2, 0).contiguous(), ff.element_ops(u0, p)]
        band = B.BandCholPrecond(pde.W, [pde.W.dofmap, ff.block.dofmap])
        st = band.setup(ops)
        if dev == "cuda":
            st2 = band.setup(ops)
            assert all(torch.equal(st[k], st2[k]) for k in st)
        v = torch.as_tensor(np.random.default_rng(1).standard_normal(nd),
                            **kw)
        res[dev] = {k: t.cpu() for k, t in st.items()}
        res[dev]["x"] = band.apply(st, v).cpu()
    for k in ("Ld", "Lc", "s"):
        assert _rel(res["cuda"][k], res["cpu"][k]) <= 1e-10, k
    assert _rel(res["cuda"]["x"], res["cpu"]["x"]) <= 1e-8


def test_wing_model_on_card_matches_cpu(cuda):
    """RMShellModel with penalty BCs on the 8x36 wing (8,823 dofs: the band
    path) on the card against the CPU: the outputs, the displacement and
    the gradient of aggregated_stress; the card ran the fused operator and
    K2, the CPU no kernel."""
    from femo_alpha_tpu_torch.mesh import createWingShellMesh

    mesh = createWingShellMesh(8, 36, rib_stations=(18,))
    res = {}
    for dev in ("cpu", "cuda"):
        model = RMShellModel(mesh, shell_bc_func=lambda x: np.abs(x[:, 1])
                             < 1e-9, element_wise_material=True,
                             mesh_tags=mesh.cell_tags, device=dev)
        assert model.band.b > 0
        kw = dict(dtype=torch.float64, device=dev)
        nel, nn = mesh.n_cells, mesh.n_nodes
        f = torch.zeros(3 * nn, **kw)
        f[2::3] = 50.0
        th = torch.full((nel,), 0.02, **kw).requires_grad_(True)
        ck.reset_launch_counts()
        out = model.evaluate(f, th, torch.full((nel,), 7e10, **kw),
                             torch.full((nel,), 0.33, **kw),
                             torch.full((nel,), 2700.0, **kw))
        out.aggregated_stress.backward()
        res[dev] = dict(launches=ck.launch_counts(), grad=th.grad.cpu(),
                        u=out.disp_solid.detach().cpu(),
                        **{k: float(getattr(out, k).detach()) for k in
                           ("compliance", "mass", "aggregated_stress",
                            "pnorm_stress_1", "pnorm_stress_2")})
    assert res["cpu"]["launches"] == {"cell_matvec_T": 0,
                                      "affine_combine": 0,
                                      "constrained_matvec_T": 0}
    assert res["cuda"]["launches"]["constrained_matvec_T"] > 0
    assert res["cuda"]["launches"]["affine_combine"] > 0
    for k in ("compliance", "mass", "aggregated_stress"):
        assert abs(res["cuda"][k] / res["cpu"][k] - 1) <= 1e-9, k
    for k in ("pnorm_stress_1", "pnorm_stress_2"):  # sigma^100
        assert abs(res["cuda"][k] / res["cpu"][k] - 1) <= 1e-7, k
    assert _rel(res["cuda"]["u"], res["cpu"]["u"]) <= 1e-8
    assert _rel(res["cuda"]["grad"], res["cpu"]["grad"]) <= 1e-6


def _transient(dev, launches=None):
    """The 16x8 transient (MG, two levels, 6 steps) on `dev`: simulate_outputs
    + backward of total_strain_energy. Returns (energy, w_final, grad)."""
    from femo_alpha_tpu_torch.mesh import StructuredQuadMesh
    from femo_alpha_tpu_torch.models.dynamic_rm_shell import PlateSim

    sim = PlateSim(StructuredQuadMesh(16, 8, (0, 0), (10.0, 2.0), gdim=3),
                   4.32e8, 0.0, 10.0, dt=0.005, Nsteps=6,
                   element_wise_thickness=True, mg_coarsest_cells=32,
                   device=dev)
    assert sim.solver_method == "mg" and len(sim.mg.levels) == 2
    rng = np.random.default_rng(0)
    th = torch.as_tensor(0.2 * (1 + 0.1 * rng.uniform(-1, 1, sim.num_var)),
                         device=dev).requires_grad_(True)
    fh = torch.zeros((7, sim.W_f.n_dofs), dtype=torch.float64, device=dev)
    fh[:, 2::3] = 1000.0
    ck.reset_launch_counts()
    out = sim.simulate_outputs(th, fh, segment_len=3)
    out["total_strain_energy"].backward()
    if launches is not None:
        launches.update(ck.launch_counts())
    return (float(out["total_strain_energy"].detach()),
            out["w_final"].detach().cpu(), th.grad.cpu(), sim)


def test_transient_on_card_matches_cpu(cuda):
    """PlateSim (16x8, MG) on the card against the CPU: the energy, the
    final state and the thickness gradient; the card ran the fused
    operator and K2, never the standalone K1."""
    launched = {}
    e_c, w_c, g_c, _ = _transient("cpu")
    e_g, w_g, g_g, _ = _transient("cuda", launched)
    assert launched["constrained_matvec_T"] > 0
    assert launched["affine_combine"] > 0
    assert launched["cell_matvec_T"] == 0
    assert abs(e_g / e_c - 1) <= 1e-9
    assert _rel(w_g, w_c) <= 1e-8
    assert _rel(g_g, g_c) <= 1e-7


def test_transient_checkpoint_recompute_is_bitwise(cuda, monkeypatch):
    """Recomputing a checkpointed segment in the backward reproduces every
    step's right-hand side and solution bit for bit (the gradient then
    equals the history path's)."""
    from femo_alpha_tpu_torch.models.dynamic_rm_shell import plate_sim

    solves = []
    solve = plate_sim._StepOperators.solve

    def recording(self, b, phase):
        w = solve(self, b, phase)
        solves.append((phase, b.clone(), w.clone()))
        return w

    monkeypatch.setattr(plate_sim._StepOperators, "solve", recording)
    _transient("cuda")
    fwd = [(b, w) for ph, b, w in solves if ph == "forward"]
    assert len(fwd) == 12  # 6 steps, then 6 recomputed in the backward
    first, again = fwd[:6], fwd[6:]
    for b, w in again:
        assert any(torch.equal(b, b0) and torch.equal(w, w0)
                   for b0, w0 in first)


def test_mg_setup_is_bitwise_repeatable(cuda):
    """Two V-cycle setups of one design give the same bits (the block-Jacobi
    blocks and the coarse matrix are summed in a fixed order, without
    atomics), so two simulations of one design take the same CG path."""
    _, _, _, sim = _transient("cuda")
    th = torch.full((sim.num_var,), 0.2, dtype=torch.float64, device="cuda")
    Ae = ck.affine_combine(sim._bases(th)[2], th, (1, 3))
    s1, s2 = (sim.mg.setup({"thickness": th}, Ae0=Ae) for _ in range(2))
    for a, b in zip(s1["blocks"][0], s2["blocks"][0]):
        assert torch.equal(a, b)
    assert torch.equal(torch.stack(s1["lmax"]), torch.stack(s2["lmax"]))
    assert torch.equal(s1["coarse_inv"], s2["coarse_inv"])
    v = torch.randn(sim.fe_dofs, generator=cuda, device="cuda",
                    dtype=torch.float64)
    assert torch.equal(sim.mg.apply(s1, v), sim.mg.apply(s2, v))


def test_lobpcg_on_card_matches_cpu(cuda):
    """evaluate_modal by LOBPCG preconditioned by the MG V-cycle (64x16,
    16,086 dofs) on the card against the same run on the CPU: eigenvalues
    to 1e-10 (cuSOLVER's and LAPACK's Gram eigh may prune differently, so
    iteration counts are not compared); the card ran the fused operator
    and K2 (K = 2 for K, K = 1 for M), never the standalone K1; the
    eigenvalue gradient of modal_eigenvalues to 1e-7."""
    mesh = _rect(64, 16)
    nel = mesh.n_cells
    res = {}
    for dev in ("cpu", "cuda"):
        model = RMShellModel(mesh, shell_bc_func=_clamped,
                             element_wise_material=True, PENALTY_BC=False,
                             device=dev)
        kw = dict(dtype=torch.float64, device=dev)
        args = (torch.full((nel,), 0.2, **kw),
                torch.full((nel,), 4.32e8, **kw), torch.zeros(nel, **kw),
                torch.full((nel,), 100.0, **kw))
        ck.reset_launch_counts()
        out = model.evaluate_modal(*args, n_modes=3, solver="lobpcg",
                                   tol=1e-8, maxiter=200, seed=0)
        launched = ck.launch_counts()
        th = args[0].clone().requires_grad_(True)
        lam1 = model.modal_eigenvalues(th, *args[1:], n_modes=1)[0]
        lam1.backward()
        res[dev] = (out.eigenvalues.detach().cpu(), out.res_norms.cpu(),
                    launched, th.grad.cpu())
    assert res["cuda"][2]["constrained_matvec_T"] > 0
    assert res["cuda"][2]["affine_combine"] > 0
    assert res["cuda"][2]["cell_matvec_T"] == 0
    assert _rel(res["cuda"][0], res["cpu"][0]) <= 1e-10
    assert float(res["cuda"][1].max()) <= 1e-5
    assert _rel(res["cuda"][3], res["cpu"][3]) <= 1e-7


def test_optimization_problem_defaults_to_the_card(cuda):
    """OptimizationProblem without device= hands the model card tensors;
    the csdl operations run on their FEA's device (the card by default)."""
    from femo_alpha_tpu_torch.csdl_opt import StateOperation
    from femo_alpha_tpu_torch.opt import OptimizationProblem

    seen = []

    def ev(dv):
        seen.append(dv["x"].device.type)
        return {"obj": torch.sum((dv["x"] - 2.0) ** 2)}

    prob = OptimizationProblem(ev)
    assert prob.device.type == "cuda"
    prob.add_design_variable("x", np.zeros(3))
    prob.set_objective("obj")
    dvs, res = prob.solve(maxiter=50, report=False)
    assert res.success and dvs["x"].is_cuda and set(seen) == {"cuda"}
    torch.testing.assert_close(dvs["x"].cpu(), torch.full(
        (3,), 2.0, dtype=torch.float64), rtol=0, atol=1e-8)
    model = RMShellModel(_rect(8, 4), shell_bc_func=_clamped,
                         element_wise_material=True, PENALTY_BC=False)
    mesh = model.mesh
    op = StateOperation(model.fea, "disp_solid")
    f = np.zeros(3 * mesh.n_nodes)
    f[2::3] = 1.0
    u = op.evaluate({"thickness": np.full(mesh.n_cells, 0.1), "F_solid": f,
                     "E": np.full(mesh.n_cells, 1e9),
                     "nu": np.full(mesh.n_cells, 0.3),
                     "uhat": np.zeros(3 * mesh.n_nodes)})
    assert u.is_cuda and op.apply_inverse_jacobian(u, "rev").is_cuda


PAV_WING = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "pav_like_wing_2388.msh")


def _pav_wing_run():
    """A fresh RMShellModel of the PAV wing (penalty BCs, mesh tags, f64,
    band path), one evaluate at h = 0.005 under the PAV example's elliptic
    4,000 Pa lift, and the backward of aggregated_stress, as chip_smoke.py's
    wing phase builds them: {name: tensor} of u, every output and the
    thickness gradient."""
    from femo_alpha_tpu_torch.mesh import readFEAMesh

    mesh = readFEAMesh(PAV_WING)
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 1] < 1e-9,
                         element_wise_material=True,
                         mesh_tags={t: np.asarray(c)
                                    for t, c in mesh.cell_tags.items()})
    assert model.band.b > 0
    nel, nn = mesh.n_cells, mesh.n_nodes
    eta = np.clip(mesh.coords[:, 1] / mesh.coords[:, 1].max(), 0.0, 1.0)
    P = np.zeros((nn, 3))
    P[:, 2] = 4000.0 * np.sqrt(1.0 - eta ** 2)
    kw = dict(dtype=torch.float64, device="cuda")
    th = torch.full((nel,), 0.005, **kw).requires_grad_(True)
    out = model.evaluate(torch.as_tensor(P, **kw), th,
                         torch.full((nel,), 71.7e9, **kw),
                         torch.full((nel,), 0.33, **kw),
                         torch.full((nel,), 2780.0, **kw))
    out.aggregated_stress.backward()
    names = ["disp_solid", "aggregated_stress", "disp_extracted",
             *model.fea.outputs, *model.fea.field_outputs]
    vals = {k: getattr(out, k).detach().clone() for k in names}
    vals["thickness_grad"] = th.grad.clone()
    return vals


def test_wing_evaluate_and_stress_backward_are_bitwise_repeatable(cuda):
    """Two fresh models of the PAV wing on the card give the same bits in
    u, every output and the gradient of aggregated_stress: every sum on
    the path runs in a fixed order, so a design study repeats itself from
    run to run."""
    a, b = _pav_wing_run(), _pav_wing_run()
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    assert not differ, differ


def _moved_plate_run(device):
    """A fresh 64x16 plate model (MG path) on `device`, one evaluate with
    node_disp = benchmarks.planform_shape in y, node_disp and thickness
    requiring grad (the direct assembly path), and the compliance
    backward: {name: tensor on the CPU}."""
    from femo_alpha_tpu_torch.benchmarks import planform_shape

    mesh = _rect(64, 16)
    model = RMShellModel(mesh, shell_bc_func=_clamped,
                         element_wise_material=True, PENALTY_BC=False,
                         device=device)
    nel, nn = mesh.n_cells, mesh.n_nodes
    kw = dict(dtype=torch.float64, device=device)
    f = torch.zeros(3 * nn, **kw)
    f[2::3] = 2.0
    nd = torch.zeros((nn, 3), **kw)
    nd[:, 1] = torch.as_tensor(planform_shape(mesh.coords), **kw)
    nd.requires_grad_(True)
    th = torch.full((nel,), 0.2, **kw).requires_grad_(True)
    out = model.evaluate(f, th, torch.full((nel,), 4.32e8, **kw),
                         torch.zeros(nel, **kw), torch.full((nel,), 100.0, **kw),
                         node_disp=nd)
    out.compliance.backward()
    return {"disp_solid": out.disp_solid.detach().cpu(),
            "compliance": out.compliance.detach().cpu().reshape(1),
            "node_disp_grad": nd.grad.cpu(), "thickness_grad": th.grad.cpu()}


def test_moved_plate_on_card_matches_cpu_and_repeats_bitwise(cuda):
    """A moved plate's evaluate + compliance backward in node_disp and
    thickness: two fresh models on the card give the same bits, and the
    card's values equal the CPU port's: the compliance to 1e-10; the
    state, which each device's MG-PCG stops at a relative residual of
    1e-11 by its own rounding, to 1e-9 (3.9e-10 measured on an H100), and
    the gradients, one adjoint solve further, to 1e-8."""
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (sm_90)")
    a, b = _moved_plate_run("cuda"), _moved_plate_run("cuda")
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    assert not differ, differ
    c = _moved_plate_run("cpu")
    bars = {"compliance": 1e-10, "disp_solid": 1e-9, "node_disp_grad": 1e-8,
            "thickness_grad": 1e-8}
    errs = {k: _rel(a[k], c[k]) for k in a}
    assert all(errs[k] <= bars[k] for k in a), errs


def test_indexed_gather_backward_is_bitwise_repeatable(cuda):
    """The backward of x[dofmap] on the PAV wing's space (the gathers of
    the unstructured assembly) gives the same bits every time."""
    from femo_alpha_tpu_torch.mesh import readFEAMesh

    pde = RMShellPDE(readFEAMesh(PAV_WING), element_wise_material=True,
                     device="cuda")
    W = pde.W
    x = torch.randn(W.n_dofs, generator=cuda, device="cuda",
                    dtype=torch.float64).requires_grad_(True)
    G = torch.randn((pde.mesh.n_cells, W.nd_local), generator=cuda,
                    device="cuda", dtype=torch.float64)
    grads = [torch.autograd.grad(W.gather(x), x, G)[0] for _ in range(5)]
    assert all(torch.equal(g, grads[0]) for g in grads[1:])


@pytest.fixture(scope="module")
def plate_bench():
    """The port's LibraryBench at 128x32 on the card, one warm call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from femo_alpha_tpu_torch.benchmarks import LibraryBench

    b = LibraryBench(nx=128, ny=32)
    return b, b.timed_run(repeats=1)


def test_library_bench_on_card_gives_the_slice_digits(plate_bench):
    from femo_alpha_tpu_torch.benchmarks import quality_verdict

    b, out = plate_bench
    assert b.device.type == "cuda" and out["n_dofs"] == 62886
    assert abs(out["J"] / 4.387311691e-03 - 1.0) <= 1e-8
    assert abs(out["grad_norm"] / 4.980959076e-04 - 1.0) <= 1e-6
    assert quality_verdict(out["res_fwd"], out["res_floor"]) == "OK"
    # the timed calls run the fused operator and K2, never the standalone K1
    launches = out["launches"]
    assert launches["constrained_matvec_T"] > 0
    assert launches["affine_combine"] > 0
    assert launches["cell_matvec_T"] == 0


def test_quality_abs_matvec_k1_matches_twin(plate_bench):
    """|A||u| of utils/quality.py launches the standalone K1 on the card;
    the same product through K1's plain twin agrees to 1e-14."""
    from femo_alpha_tpu_torch.utils.quality import make_abs_matvec

    b, _ = plate_bench
    pde, W = b.pde, b.pde._op_specs[0]
    u = torch.as_tensor(b.last_u, device="cuda")
    with torch.no_grad():
        params = b.params(b.th0)
        emb, _, fops = pde._prepare_aux(params)
        ops = pde._assemble_ops(torch.zeros_like(u), params, emf_basis=emb,
                                facet_ops=fops)
        ck.reset_launch_counts()
        y = make_abs_matvec(pde)(ops, u)
        assert ck.launch_counts()["cell_matvec_T"] == 1
        yp = W.scatter_add_T(ck.cell_matvec_T_plain(
            ops[0].abs(), W.gather_T(u.abs()).contiguous()))
    assert _rel(y, yp) <= 1e-14


def _amg_wing(dev):
    """The penalty wing of tests/test_torch_amg.py (10x24, ribs at 12,
    shuffle 3, 7,431 dofs) on `dev` with the reference's AMG + penalty
    split on its operator: (AMGPrecondFactory, its state, the cell block
    (nd, nd, nc))."""
    from femo_alpha_tpu_torch.mesh import createWingShellMesh
    from femo_alpha_tpu_torch.solvers.amg import AMGPrecondFactory

    mesh = createWingShellMesh(n_chord=10, n_span=24, rib_stations=(12,),
                               shuffle_seed=3)
    pde = RMShellPDE(mesh, element_wise_material=True, device=dev)
    form = pde.make_residual_form()
    ff = pde.make_penalty_facet_form(lambda x: x[:, 1] < 1e-9)
    pc = AMGPrecondFactory(pde.W, form, [ff])
    kw = dict(dtype=torch.float64, device=dev)
    nel, nn = mesh.n_cells, mesh.n_nodes
    p = {"thickness": torch.full((nel,), 0.2, **kw),
         "E": torch.full((nel,), 4.32e8, **kw),
         "nu": torch.zeros(nel, **kw), "uhat": torch.zeros(3 * nn, **kw),
         "F_solid": torch.zeros(3 * nn, **kw)}
    u0 = torch.zeros(pde.W.n_dofs, **kw)
    from femo_alpha_tpu_torch.assembly.assemble import element_matrices

    Ae = element_matrices(form, u0, p).permute(1, 2, 0).contiguous()
    ops = [Ae, ff.element_ops(u0, p)]
    return pc, pc.setup_state(u0, p, ops, ()), Ae


def test_schwarz_apply_k1_matches_twin(cuda):
    """The AMG's Schwarz smoother apply (apply_schwarz_T: K1 on the
    inverted, diagonal-corrected element blocks at nd 39) on the card
    against the plain twin on the same blocks, within 1e-13; it launches
    K1 once."""
    from femo_alpha_tpu_torch.solvers.multigrid import apply_schwarz_T

    pc, st, _ = _amg_wing("cuda")
    inv_T, sw_T = st["amg"]["sm"]
    W = pc.amg.space
    v = torch.randn(W.n_dofs, generator=cuda, device="cuda",
                    dtype=torch.float64)
    ck.reset_launch_counts()
    y = apply_schwarz_T(W, inv_T, sw_T, v)
    assert ck.launch_counts()["cell_matvec_T"] == 1
    vcT = W.gather_T(v) * sw_T
    y_plain = W.scatter_add_T(ck.cell_matvec_T_plain(inv_T, vcT) * sw_T)
    assert _rel(y, y_plain) <= 1e-13


def test_amg_setup_and_apply_are_bitwise_repeatable(cuda):
    """Two AMG setups of one operator give the same bits (Schwarz blocks,
    lambda_max, coarse inverse: every sum in a fixed order), two applies
    the same bits, and the apply matches the CPU's within 1e-10."""
    pc, s1, _ = _amg_wing("cuda")
    _, s2, _ = _amg_wing("cuda")
    for k in ("lmax", "coarse_inv", "coarse_scale"):
        assert torch.equal(s1["amg"][k], s2["amg"][k]), k
    assert torch.equal(s1["amg"]["sm"][0], s2["amg"]["sm"][0])
    v = torch.randn(pc.amg.space.n_dofs, generator=cuda, device="cuda",
                    dtype=torch.float64)
    y1 = pc.apply_state(s1, v)
    assert torch.equal(y1, pc.apply_state(s1, v))
    assert torch.equal(y1, pc.apply_state(s2, v))
    pc_c, s_c, _ = _amg_wing("cpu")
    assert _rel(y1.cpu(), pc_c.apply_state(s_c, v.cpu())) <= 1e-10
