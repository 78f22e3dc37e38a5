"""Geometric-MG parity on a 16x8 plate with three levels (coarsest_cells
lowered to 8): the port's hierarchy, fed the reference's per-level affine
bases through interop, matches femo_alpha_tpu's V-cycle (f64, cells layout,
FEMO_* solver flags unset) level by level, and PCG with it takes the same
number of iterations. The transfers are exact adjoints of each other."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from femo_alpha_tpu.assembly.assemble import assemble_residual as ref_res
from femo_alpha_tpu.mesh import createRectangleMesh as ref_rect
from femo_alpha_tpu.models.rm_shell.mg import (
    ShellMGPrecond as RefPrecond,
    build_shell_mg as ref_build,
)
from femo_alpha_tpu.models.rm_shell.pde import RMShellPDE as RefPDE
from femo_alpha_tpu.solvers.linear import LinearSolver as RefLinearSolver

from femo_alpha_tpu_torch import interop
from femo_alpha_tpu_torch.assembly.assemble import assemble_residual
from femo_alpha_tpu_torch.mesh import createRectangleMesh
from femo_alpha_tpu_torch.models.rm_shell.mg import build_shell_mg
from femo_alpha_tpu_torch.models.rm_shell.pde import RMShellPDE
from femo_alpha_tpu_torch.solvers.linear import LinearSolver
from femo_alpha_tpu_torch.solvers.multigrid import MixedTransfer

NX, NY = 16, 8
REF_FLAGS = ("FEMO_MG_F32", "FEMO_LANE_MAJOR", "FEMO_HOSTLOOP", "FEMO_CG_DF",
             "FEMO_OP_STORAGE")


def _bc(x):
    return x[:, 0] < 1e-12


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def hierarchy():
    mesh = createRectangleMesh(NX, NY, (0, 0), (10.0, 2.0), "quad", gdim=3)
    pde = RMShellPDE(mesh, element_wise_material=True, device="cpu")
    mg = build_shell_mg(pde, _bc, coarsest_cells=8, device="cpu")
    rng = np.random.default_rng(11)
    nel, nn = mesh.n_cells, mesh.n_nodes
    p = {"thickness": rng.uniform(0.15, 0.25, nel),
         "E": rng.uniform(3e8, 5e8, nel), "nu": rng.uniform(0.0, 0.3, nel),
         "uhat": np.zeros(3 * nn), "F_solid": rng.standard_normal(3 * nn)}
    with pytest.MonkeyPatch.context() as mp:
        for flag in REF_FLAGS:
            mp.delenv(flag, raising=False)
        rpde = RefPDE(ref_rect(NX, NY, (0, 0), (10.0, 2.0), "quad", gdim=3),
                      element_wise_material=True)
        rmg = ref_build(rpde, _bc, coarsest_cells=8)
        pj = {k: jnp.asarray(v) for k, v in p.items()}
        rbases = RefPrecond(rmg).prepare(pj)
        rstate = jax.jit(lambda p_, b_: rmg.setup(p_, bases=b_))(pj, rbases)
    pt = {k: interop.to_tensor(v) for k, v in p.items()}
    state = mg.setup(pt, bases=interop.mg_bases_to_lane(
        [np.asarray(b) for b in rbases], "cells"))
    return dict(pde=pde, rpde=rpde, mg=mg, rmg=rmg, p=p, pt=pt, pj=pj,
                state=state, rstate=rstate)


def test_hierarchy_shape(hierarchy):
    mg, rmg = hierarchy["mg"], hierarchy["rmg"]
    assert len(mg.levels) == len(rmg.levels) == 3
    for lev, rlev in zip(mg.levels, rmg.levels):
        assert lev["space"].n_dofs == rlev["space"].n_dofs
        np.testing.assert_array_equal(lev["free"].numpy(),
                                      np.asarray(rlev["free"]))


@pytest.mark.parametrize("level", [0, 1, 2])
def test_level_operators_match(hierarchy, level):
    Ae = hierarchy["state"]["Ae"][level]
    Ar = interop.element_matrices_to_lane(
        np.asarray(hierarchy["rstate"]["Ae"][level]), "cells")
    assert _rel(Ae.numpy(), Ar.numpy()) <= 1e-13


@pytest.mark.parametrize("level", [0, 1])
def test_smoother_spectra_match(hierarchy, level):
    lm = float(hierarchy["state"]["lmax"][level])
    lr = float(hierarchy["rstate"]["lmax"][level])
    assert abs(lm - lr) <= 1e-10 * abs(lr)


def test_coarse_inverse_matches(hierarchy):
    s, r = hierarchy["state"], hierarchy["rstate"]
    assert _rel(s["coarse_inv"].numpy(), r["coarse_inv"]) <= 1e-10
    assert _rel(s["coarse_scale"].numpy(), r["coarse_scale"]) <= 1e-13


def test_vcycle_matches(hierarchy):
    mg, rmg = hierarchy["mg"], hierarchy["rmg"]
    n = mg.levels[0]["space"].n_dofs
    b = np.random.default_rng(12).standard_normal(n) * np.asarray(
        mg.levels[0]["free"])
    y = mg.apply(hierarchy["state"], interop.to_tensor(b)).numpy()
    yr = jax.jit(rmg.apply)(hierarchy["rstate"], jnp.asarray(b))
    assert _rel(y, yr) <= 1e-10


def test_pcg_iterations_match(hierarchy):
    mg, rmg, pde = hierarchy["mg"], hierarchy["rmg"], hierarchy["pde"]
    state, rstate = hierarchy["state"], hierarchy["rstate"]
    free = mg.levels[0]["free"]
    rfree = rmg.levels[0]["free"]
    n = pde.W.n_dofs
    form = pde.make_residual_form()
    rform = hierarchy["rpde"].make_residual_form()
    b = -free * assemble_residual(form, torch.zeros(n, dtype=torch.float64),
                                  hierarchy["pt"])
    ls = LinearSolver([(state["Ae"][0], pde.W)], n, free_mask=free,
                      tol=1e-11, M=lambda v: mg.apply(state, v))
    x = ls.solve(b)

    @jax.jit
    def ref_solve(rstate_, pj_):
        bj = -rfree * ref_res(rform, jnp.zeros(n), pj_)
        rls = RefLinearSolver([(rstate_["Ae"][0], hierarchy["rpde"].W)], n,
                              free_mask=rfree, method="cg", tol=1e-11,
                              M=lambda v: rmg.apply(rstate_, v))
        xr, info = rls._krylov(rls.matvec, bj, None)
        return xr, info["iters"]

    xr, it_r = ref_solve(rstate, hierarchy["pj"])
    it = ls.last_info["iters"]
    assert abs(it - int(it_r)) <= 1, (it, int(it_r))
    assert _rel(x.numpy(), xr) <= 1e-8


def test_transfers_are_adjoint(hierarchy):
    mg = hierarchy["mg"]
    t = mg.transfers[0]
    assert isinstance(t, MixedTransfer)
    rng = np.random.default_rng(13)
    xc = torch.as_tensor(rng.standard_normal(mg.levels[1]["space"].n_dofs))
    yf = torch.as_tensor(rng.standard_normal(mg.levels[0]["space"].n_dofs))
    a = float(torch.dot(t.prolong(xc), yf))
    b = float(torch.dot(xc, t.restrict(yf)))
    assert abs(a - b) <= 1e-13 * abs(a)
