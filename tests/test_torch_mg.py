"""Geometric-MG parity on a 16x8 plate with three levels (coarsest_cells
lowered to 8): the port's hierarchy, fed the reference's per-level affine
bases through interop, matches femo_alpha_tpu's V-cycle (f64, cells layout,
FEMO_* solver flags unset) level by level, and PCG with it takes the same
number of iterations. The transfers are exact adjoints of each other.
Then the rest of the reference's multigrid module: the Schwarz smoother's
blocks and apply, the W-cycle with the Schwarz smoother, a per-level
Chebyshev degree sequence, and the generic index-table Transfer."""

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


# --------------------------------------------------------------------------
# the Schwarz smoother, the W-cycle, per-level degrees, the generic transfer
# --------------------------------------------------------------------------


def test_schwarz_arrays_and_apply_match(hierarchy):
    """schwarz_arrays on the fine level's element matrices (the reference's,
    with its strong-BC mask) and one lane-major apply, against the
    reference's cell-major pair, within 1e-12."""
    from femo_alpha_tpu.solvers.multigrid import (
        apply_schwarz as ref_apply,
        schwarz_arrays as ref_arrays,
    )
    from femo_alpha_tpu_torch.solvers.multigrid import (
        apply_schwarz_T,
        schwarz_arrays_T,
    )

    mg, rmg = hierarchy["mg"], hierarchy["rmg"]
    Ae_r = hierarchy["rstate"]["Ae"][0]
    rfree = rmg.levels[0]["free"]
    W = mg.levels[0]["space"]
    inv_T, sw_T = schwarz_arrays_T(
        interop.element_matrices_to_lane(np.asarray(Ae_r), "cells"), W,
        mg.levels[0]["free"])
    inv_r, sw_r = ref_arrays(Ae_r, rmg.levels[0]["space"], rfree)
    assert _rel(inv_T.permute(2, 0, 1).numpy(), inv_r) <= 1e-12
    assert _rel(sw_T.T.numpy(), sw_r) <= 1e-12
    v = np.random.default_rng(14).standard_normal(W.n_dofs)
    y = apply_schwarz_T(W, inv_T, sw_T, interop.to_tensor(v)).numpy()
    yr = ref_apply(rmg.levels[0]["space"], inv_r, sw_r, jnp.asarray(v))
    assert _rel(y, yr) <= 1e-12


@pytest.fixture(scope="module")
def w_hierarchy(hierarchy):
    """The 16x8 hierarchy with W-cycles and the Schwarz smoother, on both
    sides, set up from the reference's per-level bases."""
    mg = build_shell_mg(hierarchy["pde"], _bc, coarsest_cells=8,
                        device="cpu", cycle="W", smoother="schwarz")
    with pytest.MonkeyPatch.context() as mp:
        for flag in REF_FLAGS:
            mp.delenv(flag, raising=False)
        rmg = ref_build(hierarchy["rpde"], _bc, coarsest_cells=8)
        rmg.cycle, rmg.smoother = "W", "schwarz"
        rbases = RefPrecond(rmg).prepare(hierarchy["pj"])
        rstate = jax.jit(lambda p_, b_: rmg.setup(p_, bases=b_))(
            hierarchy["pj"], rbases)
    state = mg.setup(hierarchy["pt"], bases=interop.mg_bases_to_lane(
        [np.asarray(b) for b in rbases], "cells"))
    return dict(mg=mg, rmg=rmg, state=state, rstate=rstate)


def _with_ref_scalars(state, rstate):
    """The port's cycle state with the reference's lambda_max estimates and
    coarse inverse: those agree only to ~1e-11 and 1e-10
    (test_smoother_spectra_match, test_coarse_inverse_matches; the coarse
    inverse amplifies rounding by its condition number), which a whole
    cycle carries; with them shared, a cycle comparison reads the cycle
    itself (recursion, smoother, transfers) at 1e-12."""
    return {**state, "lmax": [interop.to_tensor(np.asarray(v))
                              for v in rstate["lmax"]],
            "coarse_inv": interop.to_tensor(np.asarray(rstate["coarse_inv"])),
            "coarse_scale": interop.to_tensor(
                np.asarray(rstate["coarse_scale"]))}


def test_w_cycle_schwarz_matches(w_hierarchy):
    """GeometricMG(cycle="W", smoother="schwarz"): each smoothed level's
    lambda_max within 1e-10 of the reference's; one V-cycle over the
    Schwarz levels within 1e-12 (the reference's lambda_max and coarse
    inverse shared: 1.5e-14 measured); one W-cycle within 1e-10, as
    test_vcycle_matches (3.1e-11 measured against the reference's jitted
    W-cycle, 6.9e-12 against its eager one: the reference's own two
    W-cycles differ by 3.7e-11)."""
    mg, rmg = w_hierarchy["mg"], w_hierarchy["rmg"]
    state, rstate = w_hierarchy["state"], w_hierarchy["rstate"]
    for lm, lr in zip(state["lmax"], rstate["lmax"]):
        assert abs(float(lm) - float(lr)) <= 1e-10 * abs(float(lr))
    n = mg.levels[0]["space"].n_dofs
    b = np.random.default_rng(15).standard_normal(n) * np.asarray(
        mg.levels[0]["free"])
    y = mg.apply(state, interop.to_tensor(b)).numpy()
    assert _rel(y, jax.jit(rmg.apply)(rstate, jnp.asarray(b))) <= 1e-10
    mg.cycle = rmg.cycle = "V"
    try:
        y = mg.apply(_with_ref_scalars(state, rstate),
                     interop.to_tensor(b)).numpy()
        yr = jax.jit(rmg.apply)(rstate, jnp.asarray(b))
    finally:
        mg.cycle = rmg.cycle = "W"
    assert _rel(y, yr) <= 1e-12


def test_per_level_degree_matches(hierarchy):
    """A per-level Chebyshev degree sequence (6 on the fine level, 2 below;
    a shorter sequence repeats its last entry) in one V-cycle, against
    the reference's with the same sequence, within 1e-12 (the reference's
    lambda_max and coarse inverse shared, see _with_ref_scalars)."""
    mg, rmg = hierarchy["mg"], hierarchy["rmg"]
    assert mg._degree_at(0) == 6 and mg._degree_at(2) == 6
    n = mg.levels[0]["space"].n_dofs
    b = np.random.default_rng(16).standard_normal(n) * np.asarray(
        mg.levels[0]["free"])
    old, rold = mg.degree, rmg.degree
    mg.degree = rmg.degree = (6, 2)
    try:
        assert [mg._degree_at(k) for k in range(3)] == [6, 2, 2]
        y = mg.apply(_with_ref_scalars(hierarchy["state"],
                                       hierarchy["rstate"]),
                     interop.to_tensor(b)).numpy()
        yr = jax.jit(rmg.apply)(hierarchy["rstate"], jnp.asarray(b))
    finally:
        mg.degree, rmg.degree = old, rold
    y6 = mg.apply(_with_ref_scalars(hierarchy["state"], hierarchy["rstate"]),
                  interop.to_tensor(b)).numpy()
    assert _rel(y, yr) <= 1e-12
    assert _rel(y, y6) > 1e-6  # the sequence changed the cycle


@pytest.mark.parametrize("sub", [0, 1])
def test_generic_transfer_matches(hierarchy, sub):
    """The generic index-table Transfer (space_transfer) between the fine
    and the next level's subspace `sub` (CG2 vec3, CG1 vec3) against the
    reference's space_transfer, prolong and restrict within 1e-14; it
    agrees with the slice-based StructuredTransfer (both interpolate
    exactly) and is its adjoint pair."""
    from femo_alpha_tpu.solvers.multigrid import space_transfer as ref_st
    from femo_alpha_tpu_torch.solvers.multigrid import (
        StructuredTransfer,
        Transfer,
        space_transfer,
    )

    mg, rmg = hierarchy["mg"], hierarchy["rmg"]
    sc = mg.levels[1]["space"].subspaces[sub]
    sf = mg.levels[0]["space"].subspaces[sub]
    t = space_transfer(sc, sf)
    assert isinstance(t, Transfer)
    rt = ref_st(rmg.levels[1]["space"].subspaces[sub],
                rmg.levels[0]["space"].subspaces[sub])
    st = StructuredTransfer(sc, sf)
    rng = np.random.default_rng(17 + sub)
    xc = rng.standard_normal(sc.n_dofs)
    rf = rng.standard_normal(sf.n_dofs)
    p = t.prolong(interop.to_tensor(xc))
    r = t.restrict(interop.to_tensor(rf))
    assert _rel(p.numpy(), rt.prolong(jnp.asarray(xc))) <= 1e-14
    assert _rel(r.numpy(), rt.restrict(jnp.asarray(rf))) <= 1e-14
    assert _rel(p.numpy(), st.prolong(interop.to_tensor(xc)).numpy()) <= 1e-14
    assert _rel(r.numpy(), st.restrict(interop.to_tensor(rf)).numpy()) <= 1e-14
    a = float(torch.dot(p, interop.to_tensor(rf)))
    assert abs(a - float(torch.dot(interop.to_tensor(xc), r))) <= 1e-13 * abs(a)
