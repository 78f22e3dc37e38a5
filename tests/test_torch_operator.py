"""The fused constrained operator on the CPU (the plain twin of
cuda_kernels.constrained_matvec_T, on the spaces' index tables): the
inverse table's gather-sum is the spaces' own scatter, the operator matches
the JAX package's constrain_matvec(make_matvec_T(...)) and the port's eager
composition of the same pieces, and its wrapper refuses bad input. Also:
the port's entry points run on the card unless told otherwise, so without
a card and without `device` they raise. The kernel itself runs only on the
card (tests/test_torch_gpu.py and chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from femo_alpha_tpu.assembly.assemble import make_matvec_T as ref_matvec_T
from femo_alpha_tpu.assembly.bc import constrain_matvec as ref_constrain
from femo_alpha_tpu.mesh import createRectangleMesh as ref_rect
from femo_alpha_tpu.models import RMShellModel as RefModel
from femo_alpha_tpu.spaces import FunctionSpace as RefSpace
from femo_alpha_tpu.spaces import MixedSpace as RefMixed

from femo_alpha_tpu_torch.assembly import cuda_kernels as ck
from femo_alpha_tpu_torch.assembly.assemble import (
    make_constrained_matvec_T,
    make_matvec_T,
)
from femo_alpha_tpu_torch.assembly.bc import constrain_matvec
from femo_alpha_tpu_torch import models
from femo_alpha_tpu_torch.fea import FEA
from femo_alpha_tpu_torch.mesh import createRectangleMesh
from femo_alpha_tpu_torch.models import RMShellModel
from femo_alpha_tpu_torch.models.rm_shell.mg import build_shell_mg
from femo_alpha_tpu_torch.models.rm_shell.pde import RMShellPDE
from femo_alpha_tpu_torch.spaces import (
    FunctionSpace,
    MixedSpace,
    locate_dofs_geometric,
)


def _clamped(x):
    return x[:, 0] < 1e-12


def _rect(nx, ny, structured=True):
    return createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad", gdim=3,
                               structured=structured)


def _space(kind, mesh):
    if kind == "P1":
        return FunctionSpace(mesh, "P", 1, 3)
    if kind == "P2":
        return FunctionSpace(mesh, "P", 2, 3)
    return MixedSpace(FunctionSpace(mesh, "P", 2, 3),
                      FunctionSpace(mesh, "P", 1, 3))


def _free_mask(W):
    """1.0 on free dofs, 0.0 on the clamped edge x = 0 (both fields)."""
    V0, V1 = W.subspaces
    bc = np.concatenate([locate_dofs_geometric(V0, _clamped),
                         locate_dofs_geometric(V1, _clamped) + V0.n_dofs])
    free = np.ones(W.n_dofs)
    free[bc] = 0.0
    return free


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("kind", ["P1", "P2", "CG2xCG1"])
@pytest.mark.parametrize("nx,ny", [(8, 2), (16, 4)])
def test_inverse_table_sum_is_the_scatter(kind, nx, ny):
    """Bit for bit: the table lists each dof's entries in the order in which
    the structured scatter adds them."""
    sp = _space(kind, _rect(nx, ny))
    dofmap_T, inv = sp.lane_tables("cpu")
    assert dofmap_T.dtype == inv.dtype == torch.int32
    assert tuple(inv.shape) == (sp.n_dofs, 4)
    rng = np.random.default_rng(nx * 10 + ny)
    yc = torch.as_tensor(rng.standard_normal((sp.nd_local, nx * ny)))
    torch.testing.assert_close(ck.gather_sum(yc, inv), sp.scatter_add_T(yc),
                               rtol=0, atol=0)
    x = torch.as_tensor(rng.standard_normal(sp.n_dofs))
    assert torch.equal(x[dofmap_T], sp.gather_T(x))


def test_tables_fit_any_dofmap():
    """On an unstructured mesh (indexed gather and scatter). The cell values
    are integers, so every order of summation gives the same bits."""
    sp = _space("CG2xCG1", _rect(6, 3, structured=False))
    dofmap_T, inv = sp.lane_tables("cpu")
    rng = np.random.default_rng(3)
    yc = torch.as_tensor(rng.integers(-1000, 1000, (sp.nd_local, 18)),
                         dtype=torch.float64)
    torch.testing.assert_close(ck.gather_sum(yc, inv), sp.scatter_add_T(yc),
                               rtol=0, atol=0)
    x = torch.as_tensor(rng.standard_normal(sp.n_dofs))
    assert torch.equal(x[dofmap_T], sp.gather_T(x))


def test_plain_operator_matches_reference():
    """Against the JAX package's constrained lane-major operator on the
    shell's mixed space at 16x4 (f64). Bar 1e-14 relative: a length-39 dot
    product per cell row plus at most 4 summands per dof."""
    mesh = _rect(16, 4)
    W = _space("CG2xCG1", mesh)
    rmesh = ref_rect(16, 4, (0, 0), (10.0, 2.0), "quad", gdim=3)
    RW = RefMixed(RefSpace(rmesh, "P", 2, 3), RefSpace(rmesh, "P", 1, 3))
    rng = np.random.default_rng(21)
    Ae = rng.standard_normal((W.nd_local, W.nd_local, mesh.n_cells))
    x = rng.standard_normal(W.n_dofs)
    free = _free_mask(W)
    assert 0 < free.sum() < W.n_dofs
    y = make_constrained_matvec_T(torch.as_tensor(Ae), W,
                                  torch.as_tensor(free))(torch.as_tensor(x))
    yr = ref_constrain(ref_matvec_T(jnp.asarray(Ae), RW),
                       jnp.asarray(free))(jnp.asarray(x))
    assert _rel(y.numpy(), np.asarray(yr)) <= 1e-14


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_operator_is_the_eager_composition(dtype):
    """The same bits as the port's eager gather -> K1 twin -> scatter ->
    masks, which the solve path ran before the fused operator."""
    mesh = _rect(16, 4)
    W = _space("CG2xCG1", mesh)
    rng = np.random.default_rng(22)
    Ae = torch.as_tensor(rng.standard_normal(
        (W.nd_local, W.nd_local, mesh.n_cells)), dtype=dtype)
    x = torch.as_tensor(rng.standard_normal(W.n_dofs), dtype=dtype)
    free = torch.as_tensor(_free_mask(W), dtype=dtype)
    y = make_constrained_matvec_T(Ae, W, free)(x)
    assert y.dtype == dtype
    torch.testing.assert_close(
        y, constrain_matvec(make_matvec_T(Ae, W), free)(x), rtol=0, atol=0)


@pytest.mark.parametrize("case", ["shape", "dtype", "device", "grad"])
def test_fused_wrapper_refuses_bad_input(case):
    sp = FunctionSpace(_rect(4, 2), "P", 1)
    dofmap_T, inv = sp.lane_tables("cpu")
    Ae = torch.zeros((4, 4, 8), dtype=torch.float64)
    free = torch.ones(sp.n_dofs, dtype=torch.float64)
    if case == "shape":
        with pytest.raises(ValueError):
            ck.constrained_matvec_T(Ae[:3, :3], free, dofmap_T, inv)
        with pytest.raises(ValueError):
            ck.constrained_matvec_T(Ae, free[1:], dofmap_T, inv)
    elif case == "dtype":
        with pytest.raises(TypeError):
            ck.constrained_matvec_T(Ae, free.float(), dofmap_T, inv)
        with pytest.raises(TypeError):
            ck.constrained_matvec_T(Ae, free, dofmap_T.long(), inv)
        with pytest.raises(TypeError):
            ck.constrained_matvec_T(Ae.half(), free.half(), dofmap_T, inv)
    elif case == "device":
        # a non-CPU, non-CUDA tensor neither runs the twin nor a kernel
        with pytest.raises(ValueError):
            ck.constrained_matvec_T(Ae.to("meta"), free.to("meta"),
                                    dofmap_T, inv)
    else:
        with pytest.raises(RuntimeError):
            ck.constrained_matvec_T(Ae.requires_grad_(True), free, dofmap_T,
                                    inv)


def _entry_point(what):
    mesh = _rect(64, 16)
    if what == "RMShellModel":
        return RMShellModel(mesh, shell_bc_func=_clamped,
                            element_wise_material=True, PENALTY_BC=False)
    if what == "RMShellModel_penalty":
        return RMShellModel(mesh, shell_bc_func=_clamped,
                            element_wise_material=True)
    if what == "FEA":
        return FEA(mesh)
    if what == "RMShellPDE":
        return RMShellPDE(mesh, element_wise_material=True)
    if what in ("PoissonModel", "NonlinearPoissonModel"):
        return getattr(models, what)(createRectangleMesh(4, 4, (0, 0), (1, 1),
                                                         "triangle"))
    if what == "ElasticityModel":
        return models.ElasticityModel(createRectangleMesh(4, 2, (0, 0),
                                                          (2, 1), "quad"))
    if what == "EulerBernoulliBeamModel":
        return models.EulerBernoulliBeamModel(nel=4)
    pde = RMShellPDE(mesh, element_wise_material=True, device="cpu")
    return build_shell_mg(pde, _clamped)


@pytest.mark.parametrize("what", ["RMShellModel", "RMShellModel_penalty",
                                  "FEA", "RMShellPDE", "build_shell_mg",
                                  "PoissonModel", "NonlinearPoissonModel",
                                  "ElasticityModel",
                                  "EulerBernoulliBeamModel"])
def test_entry_points_without_a_card_raise(what, monkeypatch):
    """With no `device` the entry points take the card; where there is none
    they raise and say how to ask for the CPU (never a silent fallback).
    The test takes the card away itself, so it checks the same on any
    machine."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _entry_point(what)


@pytest.mark.parametrize("what,nx,ny", [("penalty", 64, 16),
                                        ("dense", 8, 2),
                                        ("no_hierarchy", 30, 16)])
def test_unported_configurations_raise_before_the_device(what, nx, ny,
                                                         monkeypatch):
    """On the band path of a structured mesh with no multigrid hierarchy
    an unported option (dtype=float32) raises before the device is looked
    at; the CG2CR1 element, once unported, builds on the penalty triangle
    plate (22,227 dofs) and takes the band Cholesky, as the reference.
    On the dense plate, custom solver_opts are ported: used verbatim, as
    the reference uses them, the shell is solved by the reference's
    Jacobi-CG instead of the dense Cholesky, and the state and compliance
    match the JAX package's model with the same options to 1e-9 (CG to a
    relative residual of 1e-12 in both; measured 7.8e-11). (Jacobi-GMRES
    stagnates on this shell in both packages, so its iterate is no parity
    oracle.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if what == "dense":
        opts = {"method": "cg", "tol": 1e-12}
        mesh = _rect(nx, ny)
        model = RMShellModel(mesh, shell_bc_func=_clamped,
                             element_wise_material=True, PENALTY_BC=False,
                             solver_opts=dict(opts), device="cpu")
        ref = RefModel(ref_rect(nx, ny, (0, 0), (10.0, 2.0), "quad", gdim=3),
                       shell_bc_func=_clamped, element_wise_material=True,
                       PENALTY_BC=False, solver_opts=dict(opts))
        nel, nn = mesh.n_cells, mesh.n_nodes
        f = np.zeros((nn, 3))
        f[:, 2] = 2.0
        args = (f, np.full(nel, 0.2), np.full(nel, 4.32e8), np.zeros(nel),
                np.full(nel, 100.0))
        out = model.evaluate(*args)
        out_r = ref.evaluate(*[jnp.asarray(a) for a in args])
        u, u_r = out.disp_solid.detach().numpy(), np.asarray(out_r.disp_solid)
        assert np.linalg.norm(u - u_r) / np.linalg.norm(u_r) <= 1e-9
        assert float(out.compliance.detach()) == pytest.approx(
            float(out_r.compliance), rel=1e-9)
        assert model.fea.states["disp_solid"].pde.last_info["forward"][
            "iters"] > 0
        return
    if what == "penalty":
        # CG2CR1 is ported: on the penalty triangle plate it builds without
        # a card (device="cpu") and takes the band Cholesky
        mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "triangle",
                                   gdim=3)
        model = RMShellModel(mesh, shell_bc_func=_clamped,
                             element_wise_material=True,
                             element_type="CG2CR1", device="cpu")
        pde = model.fea.states["disp_solid"].pde
        assert type(pde._pc).__name__ == "BandPrecond"
        assert model.band is not None and pde.n_dofs > 6000
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        RMShellModel(_rect(nx, ny), shell_bc_func=_clamped,
                     element_wise_material=True, dtype=torch.float32)
