"""The aggregation AMG of femo_alpha_tpu_torch (solvers/amg.py) against the
reference's on the 6x8 wing of tests/test_amg.py, both fed the reference's
element matrices: the aggregates and prolongator weights, P and R, the
Galerkin coarse matrix (and against a dense P^T A P), the penalty mask and
one penalty-split apply; the port's split preconditioner is symmetric
positive. Then the model: on tests/test_amg.py's 10x24 wing the band
memory guard, forced low, selects AMGPrecondFactory and the result
matches the port's own band path at that test's bars and the reference's
AMG run (pinned digits of tools/amg_reference_digits.py small)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from femo_alpha_tpu.assembly.assemble import element_matrices as ref_em
from femo_alpha_tpu.mesh import createWingShellMesh as ref_wing
from femo_alpha_tpu.models.rm_shell.pde import RMShellPDE as RefPDE
from femo_alpha_tpu.solvers.amg import (
    AggregationAMG as RefAMG,
    build_penalty_split_precond as ref_split,
    penalty_split as ref_penalty_split,
)

from femo_alpha_tpu_torch import interop
from femo_alpha_tpu_torch.assembly.assemble import make_matvec_T
from femo_alpha_tpu_torch.mesh import createWingShellMesh
from femo_alpha_tpu_torch.models.rm_shell.pde import RMShellPDE
from femo_alpha_tpu_torch.solvers.amg import (
    AggregationAMG,
    AMGPrecondFactory,
    build_penalty_split_precond,
    penalty_split,
)

# tools/amg_reference_digits.py small: the reference's first call on the
# 10x24 wing with the guard forced low (AMG), f64 on the CPU
SMALL_DIGITS = {"compliance": 5.043169254980571e-01,
                "grad_norm": 6.642850551023021e-01, "iters_fwd": 865}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _root(x):
    return np.abs(x[:, 1]) < 1e-9


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def wing():
    m = ref_wing(n_chord=6, n_span=8, rib_stations=(4,))
    rpde = RefPDE(m, element_wise_material=True)
    n = rpde.W.n_dofs
    nel = m.n_cells
    p = {"thickness": np.full(nel, 0.01), "E": np.full(nel, 7e10),
         "nu": np.full(nel, 0.33), "uhat": np.zeros(3 * m.n_nodes),
         "F_solid": np.zeros(3 * m.n_nodes)}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    Ae = ref_em(rpde.make_residual_form(), jnp.zeros(n), pj)
    rfacet = rpde.make_penalty_facet_form(_root).element_ops(jnp.zeros(n),
                                                            pj)
    ramg = RefAMG(rpde.W)

    tm = createWingShellMesh(n_chord=6, n_span=8, rib_stations=(4,))
    pde = RMShellPDE(tm, element_wise_material=True, device="cpu")
    ff = pde.make_penalty_facet_form(_root)
    pt = {k: interop.to_tensor(v) for k, v in p.items()}
    facet = [(ff.element_ops(torch.zeros(n, dtype=torch.float64), pt),
              ff.block)]
    amg = AggregationAMG(pde.W)
    Ae_T = interop.element_matrices_to_lane(np.asarray(Ae), "cells")
    return dict(n=n, Ae=Ae, rfacet=rfacet, ramg=ramg, pde=pde, facet=facet,
                amg=amg, Ae_T=Ae_T, rW=rpde.W)


def test_aggregates_and_weights_match(wing):
    amg, ramg = wing["amg"], wing["ramg"]
    assert amg.n_agg == ramg.n_agg and amg.nc_dofs == ramg.nc_dofs
    np.testing.assert_array_equal(amg.agg, np.asarray(ramg.agg_d))
    w_ref = np.stack([np.asarray(c) for c in ramg.w_cols], axis=1)
    np.testing.assert_array_equal(amg.w, w_ref)


@pytest.mark.parametrize("op", ["prolong", "restrict"])
def test_transfers_match(wing, op):
    amg, ramg = wing["amg"], wing["ramg"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal(amg.nc_dofs if op == "prolong" else wing["n"])
    y = getattr(amg, op)(torch.as_tensor(x)).numpy()
    yr = np.asarray(getattr(ramg, op)(jnp.asarray(x)))
    assert _rel(y, yr) <= 1e-13


def test_restrict_is_prolong_adjoint(wing):
    amg = wing["amg"]
    rng = np.random.default_rng(2)
    xc = torch.as_tensor(rng.standard_normal(amg.nc_dofs))
    y = torch.as_tensor(rng.standard_normal(wing["n"]))
    a = float(torch.dot(amg.prolong(xc), y))
    b = float(torch.dot(xc, amg.restrict(y)))
    assert abs(a - b) <= 1e-13 * abs(a)


def test_penalty_mask_matches(wing):
    pm, pd = penalty_split(wing["facet"], wing["n"])
    rpm, rpd = ref_penalty_split(wing["rfacet"], wing["n"])
    np.testing.assert_array_equal(pm.numpy(), np.asarray(rpm))
    assert pm.sum() > 0
    assert _rel(pd.numpy(), rpd) <= 1e-13


def test_galerkin_coarse_matrix(wing):
    """The chunked cell-block coarse assembly equals a dense P^T (fAf) P
    (1e-8, as tests/test_amg.py) and the reference's pair-scatter (1e-12),
    with the penalty dofs masked."""
    amg, ramg, n = wing["amg"], wing["ramg"], wing["n"]
    pm, _ = penalty_split(wing["facet"], n)
    fm = 1.0 - pm
    Ac = amg._coarse_dense(wing["Ae_T"], fm).numpy()
    Ac_ref = np.asarray(ramg._coarse_dense(wing["Ae"], jnp.asarray(
        fm.numpy())))
    assert _rel(Ac, Ac_ref) <= 1e-12
    P = torch.stack([amg.prolong(e) for e in
                     torch.eye(amg.nc_dofs, dtype=torch.float64)], dim=1)
    mv = make_matvec_T(wing["Ae_T"], wing["pde"].W)
    AP = torch.stack([fm * mv(fm * P[:, j]) for j in range(P.shape[1])],
                     dim=1)
    direct = (P.T @ AP).numpy()
    # the guard's identity on empty coarse dofs
    direct += np.diag((np.diag(direct) == 0.0).astype(float))
    assert _rel(Ac, direct) <= 1e-8


def test_penalty_split_apply_matches(wing):
    n = wing["n"]
    M = build_penalty_split_precond(wing["amg"], wing["Ae_T"],
                                    wing["facet"], np.ones(n))
    Mr = ref_split(wing["ramg"], wing["Ae"], wing["rfacet"], jnp.ones(n))
    st, rst = M.state["amg"], Mr.state
    assert abs(float(st["lmax"]) - float(rst["lmax"])) <= 1e-10 * float(
        rst["lmax"])
    v = np.random.default_rng(3).standard_normal(n)
    y = M(torch.as_tensor(v)).numpy()
    assert _rel(y, np.asarray(Mr(jnp.asarray(v)))) <= 1e-10


def test_penalty_split_is_symmetric_positive(wing):
    n = wing["n"]
    M = build_penalty_split_precond(wing["amg"], wing["Ae_T"],
                                    wing["facet"], np.ones(n))
    rng = np.random.default_rng(4)
    v1 = torch.as_tensor(rng.standard_normal(n))
    v2 = torch.as_tensor(rng.standard_normal(n))
    s1, s2 = float(torch.dot(v2, M(v1))), float(torch.dot(v1, M(v2)))
    assert abs(s1 - s2) <= 1e-10 * abs(s1)
    assert float(torch.dot(v1, M(v1))) > 0.0


def _small_wing_run(monkeypatch, force_amg):
    from femo_alpha_tpu_torch.models import RMShellModel

    if force_amg:
        monkeypatch.setenv("FEMO_BAND_MEM_GB", "0.000001")
    else:
        monkeypatch.delenv("FEMO_BAND_MEM_GB", raising=False)
    m = createWingShellMesh(n_chord=10, n_span=24, rib_stations=(12,),
                            shuffle_seed=3)
    model = RMShellModel(m, shell_bc_func=lambda x: x[:, 1] < 1e-9,
                         element_wise_material=True, device="cpu")
    nel, nn = m.n_cells, m.n_nodes
    f = np.zeros(3 * nn)
    f[2::3] = 200.0
    th = torch.full((nel,), 0.2, dtype=torch.float64, requires_grad=True)
    out = model.evaluate(f, th, np.full(nel, 4.32e8), np.zeros(nel),
                         np.full(nel, 100.0))
    out.compliance.backward()
    pde = model.fea.states["disp_solid"].pde
    return (pde, float(out.compliance.detach()),
            out.disp_solid.detach().numpy(), th.grad.numpy())


def test_forced_guard_selects_amg_and_matches_band(monkeypatch):
    """tests/test_amg.py's model case on the port: past the guard (no
    other setting) RMShellModel selects AMGPrecondFactory, and compliance,
    u and the thickness gradient match the band path within 1e-8, 1e-7
    and 1e-5; compliance and |grad| match the reference's AMG run to 1e-8,
    its forward CG iteration count to 3 %."""
    from femo_alpha_tpu_torch.solvers.band import BandPrecond

    pde_b, J_b, u_b, g_b = _small_wing_run(monkeypatch, False)
    assert isinstance(pde_b._pc, BandPrecond)
    pde_a, J_a, u_a, g_a = _small_wing_run(monkeypatch, True)
    assert isinstance(pde_a._pc, AMGPrecondFactory)
    # CG stopped on its own test, before maxiter (the penalty system's
    # true residual floor lies above tol * |b|, so "converged", which
    # compares the true residual with that, is false on both paths)
    for phase in ("forward", "adjoint"):
        assert pde_a.last_info[phase]["iters"] < pde_a.solver_opts["maxiter"]
    assert abs(J_a - J_b) < 1e-8 * abs(J_b)
    assert _rel(u_a, u_b) < 1e-7
    assert _rel(g_a, g_b) < 1e-5
    assert abs(J_a / SMALL_DIGITS["compliance"] - 1.0) < 1e-8
    assert abs(np.linalg.norm(g_a) / SMALL_DIGITS["grad_norm"] - 1.0) < 1e-8
    # a CG run of ~850 iterations on this ill-conditioned system follows
    # rounding: the port's own count moves with the reduction order (849
    # on one CPU thread, 865 on four), so the reference's is held to 3 %
    it = pde_a.last_info["forward"]["iters"]
    assert abs(it - SMALL_DIGITS["iters_fwd"]) <= 0.03 * SMALL_DIGITS[
        "iters_fwd"], it
