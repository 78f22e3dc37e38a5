"""Shell assembly parity on an 8x2 plate (reference: femo_alpha_tpu, f64,
cells layout, FEMO_* solver flags unset): the residual, the load, the
element matrices, the parameter vjp of the residual, the output
functionals, the affine basis and its combine; the fine operator and the
BC-constrained operator are symmetric."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from femo_alpha_tpu.assembly.affine import AffineDesignOperator as RefAffine
from femo_alpha_tpu.assembly.assemble import (
    assemble_residual as ref_residual,
    assemble_scalar as ref_scalar,
    element_matrices as ref_element_matrices,
)
from femo_alpha_tpu.mesh import createRectangleMesh as ref_rect
from femo_alpha_tpu.models.rm_shell.pde import RMShellPDE as RefPDE

from femo_alpha_tpu_torch import interop
from femo_alpha_tpu_torch.assembly.affine import AffineDesignOperator
from femo_alpha_tpu_torch.assembly.assemble import (
    assemble_residual,
    assemble_scalar,
    element_matrices,
)
from femo_alpha_tpu_torch.assembly.bc import combine_bcs, DirichletBC
from femo_alpha_tpu_torch.mesh import createRectangleMesh
from femo_alpha_tpu_torch.models.rm_shell.mg import strong_bc_dofs
from femo_alpha_tpu_torch.models.rm_shell.pde import RMShellPDE
from femo_alpha_tpu_torch.solvers.linear import LinearSolver

BAR = 1e-12  # f64 assembly: same quadrature, other summation order


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def shell():
    mesh = createRectangleMesh(8, 2, (0, 0), (10.0, 2.0), "quad", gdim=3)
    pde = RMShellPDE(mesh, element_wise_material=True, device="cpu")
    rpde = RefPDE(ref_rect(8, 2, (0, 0), (10.0, 2.0), "quad", gdim=3),
                  element_wise_material=True)
    rng = np.random.default_rng(7)
    nel, nn = mesh.n_cells, mesh.n_nodes
    p = {"thickness": rng.uniform(0.1, 0.3, nel),
         "E": rng.uniform(1e8, 5e8, nel), "nu": rng.uniform(0.0, 0.3, nel),
         "uhat": 1e-2 * rng.standard_normal(3 * nn),
         "F_solid": rng.standard_normal(3 * nn)}
    u = 1e-3 * rng.standard_normal(pde.W.n_dofs)
    return dict(pde=pde, rpde=rpde, form=pde.make_residual_form(),
                rform=rpde.make_residual_form(), p=p, u=u,
                pt={k: interop.to_tensor(v) for k, v in p.items()},
                pj={k: jnp.asarray(v) for k, v in p.items()})


@pytest.mark.parametrize("state", ["random", "zero_load"])
def test_residual_and_load_match(shell, state):
    u = shell["u"] if state == "random" else np.zeros_like(shell["u"])
    r = assemble_residual(shell["form"], interop.to_tensor(u), shell["pt"])
    rr = jax.jit(lambda u_, p_: ref_residual(shell["rform"], u_, p_))(
        jnp.asarray(u), shell["pj"])
    assert _rel(r.numpy(), rr) <= BAR


def test_element_matrices_match(shell):
    u0 = np.zeros_like(shell["u"])
    Ae = element_matrices(shell["form"], interop.to_tensor(u0), shell["pt"])
    Ar = jax.jit(lambda u_, p_: ref_element_matrices(shell["rform"], u_, p_))(
        jnp.asarray(u0), shell["pj"])
    assert Ae.shape == Ar.shape == (16, 39, 39)
    assert _rel(Ae.numpy(), Ar) <= BAR


def test_residual_parameter_vjp_matches(shell):
    """The adjoint's parameter vjp: lam^T dR/dp for every parameter."""
    u = shell["u"]
    lam = np.random.default_rng(8).standard_normal(u.shape)
    keys = sorted(shell["p"])
    ut = interop.to_tensor(u)

    def res(*vals):
        return assemble_residual(shell["form"], ut, dict(zip(keys, vals)))

    _, vjp_fn = torch.func.vjp(res, *[shell["pt"][k] for k in keys])
    got = vjp_fn(interop.to_tensor(lam))

    @jax.jit
    def ref_vjp(u_, p_, lam_):
        _, rvjp = jax.vjp(lambda pp: ref_residual(shell["rform"], u_, pp), p_)
        return rvjp(lam_)[0]

    ref = ref_vjp(jnp.asarray(u), shell["pj"], jnp.asarray(lam))
    for k, g in zip(keys, got):
        assert _rel(g.numpy(), ref[k]) <= BAR, k


def test_output_functionals_match(shell):
    pde, rpde, u = shell["pde"], shell["rpde"], shell["u"]
    pt, pj = shell["pt"], shell["pj"]
    J = assemble_scalar(pde.compliance_form(), interop.to_tensor(u),
                        {"thickness": pt["thickness"], "uhat": pt["uhat"]})
    Jr = jax.jit(lambda u_, p_: ref_scalar(rpde.compliance_form(), u_, p_))(
        jnp.asarray(u), {"thickness": pj["thickness"], "uhat": pj["uhat"]})
    m = assemble_scalar(pde.mass_form(), pt["thickness"],
                        {"density": pt["E"] * 0 + 100.0, "uhat": pt["uhat"]})
    mr = jax.jit(lambda h_, p_: ref_scalar(rpde.mass_form(), h_, p_))(
        pj["thickness"], {"density": pj["E"] * 0 + 100.0, "uhat": pj["uhat"]})
    assert abs(float(J) - float(Jr)) <= BAR * abs(float(Jr))
    assert abs(float(m) - float(mr)) <= BAR * abs(float(mr))


@pytest.fixture(scope="module")
def affine(shell):
    others = {k: v for k, v in shell["p"].items() if k != "thickness"}
    aff = AffineDesignOperator(
        shell["form"], torch.zeros(len(shell["u"]), dtype=torch.float64),
        lambda th: {**{k: interop.to_tensor(v) for k, v in others.items()},
                    "thickness": th}, probe_scale=0.2)
    raff = RefAffine(shell["rform"], np.zeros(len(shell["u"])),
                     lambda th: {**others, "thickness": th},
                     probe_scale=0.2, layout="lane")
    return aff, raff


def test_affine_basis_matches(affine):
    aff, raff = affine
    ref = interop.affine_basis_to_lane(np.asarray(raff.basis), "lane")
    for k in range(2):
        assert _rel(aff.basis[k].numpy(), ref[k].numpy()) <= 1e-13


def test_affine_combine_matches(shell, affine):
    aff, raff = affine
    th = shell["p"]["thickness"] * 1.1
    Ae = aff.element_matrices(interop.to_tensor(th)).numpy()
    Ar = np.asarray(raff.element_matrices(jnp.asarray(th)))
    assert _rel(Ae, Ar) <= 1e-13
    # the port's combine on the reference's basis, fed through interop
    Ai = aff.element_matrices(
        interop.to_tensor(th),
        basis=interop.affine_basis_to_lane(np.asarray(raff.basis), "lane"))
    assert _rel(Ai.numpy(), Ar) <= 1e-15
    # and the decomposition is exact against a direct assembly
    u0 = torch.zeros(len(shell["u"]), dtype=torch.float64)
    others = {k: interop.to_tensor(v) for k, v in shell["p"].items()
              if k != "thickness"}
    assert aff.verify(interop.to_tensor(th), u0,
                      lambda t: {**others, "thickness": t}) <= 1e-13


def test_affine_basis_f32_storage(shell, affine):
    """A basis stored in f32 combines (K2 f32) to the f64 operator within
    f32 rounding, and its verify accepts it at f32 precision."""
    others = {k: interop.to_tensor(v) for k, v in shell["p"].items()
              if k != "thickness"}
    u0 = torch.zeros(len(shell["u"]), dtype=torch.float64)
    aff32 = AffineDesignOperator(
        shell["form"], u0, lambda th: {**others, "thickness": th},
        probe_scale=0.2, dtype=torch.float32)
    assert aff32.basis.dtype == torch.float32
    th = interop.to_tensor(shell["p"]["thickness"] * 1.1)
    Ae32 = aff32.element_matrices(th)
    assert Ae32.dtype == torch.float32
    assert _rel(Ae32.numpy(), affine[0].element_matrices(th).numpy()) <= 1e-6
    assert aff32.verify(th, u0, lambda t: {**others, "thickness": t}) <= 1e-5


def test_operators_are_symmetric(shell, affine):
    pde = shell["pde"]
    aff = affine[0]
    Ae = aff.element_matrices(interop.to_tensor(shell["p"]["thickness"]))
    scale = float(Ae.abs().max())
    assert float((Ae - Ae.transpose(0, 1)).abs().max()) <= 1e-13 * scale
    free, _ = combine_bcs(pde.W.n_dofs, [DirichletBC(
        strong_bc_dofs(pde, lambda x: x[:, 0] < 1e-12))])
    ls = LinearSolver([(Ae, pde.W)], pde.W.n_dofs, free_mask=free)
    rng = np.random.default_rng(9)
    x, y = (torch.as_tensor(rng.standard_normal(pde.W.n_dofs))
            for _ in range(2))
    a, b = float(torch.dot(ls.matvec(x), y)), float(torch.dot(x, ls.matvec(y)))
    assert abs(a - b) <= 1e-12 * abs(a)
