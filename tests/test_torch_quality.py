"""utils/quality.py of the port against the JAX package's: the constrained
sparse operator and its right-hand side, the backward errors of one state,
|A||u| and the direct cross-check, on an 8x4 plate with the strong clamp
and with the penalty clamp (dense solve path, f64, FEMO_* solver flags
unset), from the same seeded numpy inputs; and the refusal of a
state-dependent extra residual on both sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from femo_alpha_tpu.mesh import createRectangleMesh as ref_rect
from femo_alpha_tpu.models import RMShellModel as RefModel
from femo_alpha_tpu.utils import quality as ref_quality

from femo_alpha_tpu_torch.mesh import createRectangleMesh
from femo_alpha_tpu_torch.models import RMShellModel
from femo_alpha_tpu_torch.utils import quality

NX, NY = 8, 4
REF_FLAGS = ("FEMO_MG_F32", "FEMO_LANE_MAJOR", "FEMO_HOSTLOOP", "FEMO_CG_DF",
             "FEMO_OP_STORAGE")


def _bc(x):
    return x[:, 0] < 1e-12


def _inputs(nel, nn, rng):
    f = np.zeros(3 * nn)
    f[2::3] = rng.uniform(1.0, 3.0, nn)
    return {"thickness": rng.uniform(0.1, 0.3, nel),
            "E": np.full(nel, 4.32e8), "nu": np.full(nel, 0.3),
            "F_solid": f, "uhat": np.zeros(3 * nn)}


@pytest.fixture(scope="module", params=["strong", "penalty"])
def pair(request):
    penalty = request.param == "penalty"
    rng = np.random.default_rng(7)
    with pytest.MonkeyPatch.context() as mp:
        for flag in REF_FLAGS:
            mp.delenv(flag, raising=False)
        rmesh = ref_rect(NX, NY, (0, 0), (10.0, 2.0), "quad", gdim=3)
        ref = RefModel(rmesh, shell_bc_func=_bc, element_wise_material=True,
                       PENALTY_BC=penalty)
    mesh = createRectangleMesh(NX, NY, (0, 0), (10.0, 2.0), "quad", gdim=3)
    port = RMShellModel(mesh, shell_bc_func=_bc, element_wise_material=True,
                        PENALTY_BC=penalty, device="cpu")
    p = _inputs(mesh.n_cells, mesh.n_nodes, rng)
    n = port.shell_pde.W.n_dofs
    u = rng.standard_normal(n) * 1e-3
    ref_pde = ref.fea.states["disp_solid"].pde
    # the reference's residual, compiled once (its eager first call
    # compiles op by op, ~7 s); the same function
    ref_pde.residual = jax.jit(ref_pde.residual)
    return dict(
        ref=ref_pde,
        ref_params={k: jnp.asarray(v) for k, v in p.items()},
        pde=port.fea.states["disp_solid"].pde,
        params={k: torch.as_tensor(v, dtype=torch.float64)
                for k, v in p.items()},
        u=u)


def test_sparse_operator_matches_reference(pair):
    Br, br = ref_quality.sparse_operator(pair["ref"], pair["ref_params"])
    B, b = quality.sparse_operator(pair["pde"], pair["params"])
    assert B.shape == Br.shape
    assert abs(B - Br).max() <= 1e-12 * abs(Br).max()
    assert np.max(np.abs(b - br)) <= 1e-12 * np.max(np.abs(br))


def test_backward_errors_match_reference(pair):
    Br, br = ref_quality.sparse_operator(pair["ref"], pair["ref_params"])
    B, b = quality.sparse_operator(pair["pde"], pair["params"])
    want = ref_quality.backward_errors(Br, br, pair["u"])
    got = quality.backward_errors(B, b, pair["u"])
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


def test_abs_matvec_matches_reference(pair):
    ref, pde = pair["ref"], pair["pde"]
    aux = ref.prepare_aux(pair["ref_params"])
    ops_r = ref._assemble_ops(jnp.zeros(ref.n_dofs), pair["ref_params"],
                              emf_basis=aux[0],
                              facet_ops=aux[2] if len(aux) > 2 else None)
    want = np.asarray(ref_quality.make_abs_matvec(ref)(
        ops_r, jnp.asarray(pair["u"])))
    emb, _, fops = pde._prepare_aux(pair["params"])
    ops = pde._assemble_ops(torch.zeros(pde.n_dofs), pair["params"],
                            emf_basis=emb, facet_ops=fops)
    got = quality.make_abs_matvec(pde)(
        ops, torch.as_tensor(pair["u"])).numpy()
    assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)


def test_direct_crosscheck_matches_reference(pair):
    want = ref_quality.direct_crosscheck(pair["ref"], pair["ref_params"],
                                         pair["u"])
    got = quality.direct_crosscheck(pair["pde"], pair["params"], pair["u"])
    assert sorted(got) == sorted(want)
    for k in ("nodal_l2", "nodal_inf", "eta", "omega", "rel_res"):
        assert got[k] == pytest.approx(want[k], rel=1e-10, abs=0), k
    # both direct solves are backward stable; their rel_res sits at the
    # residual-measurement floor (eps * |||A||u||| / ||b||)
    for k, bar in (("direct_eta", 1e-15), ("direct_omega", 1e-14),
                   ("direct_rel_res", 1e-8)):
        assert got[k] <= bar and want[k] <= bar, k
    small = quality.direct_crosscheck(pair["pde"], pair["params"], pair["u"],
                                      max_dofs=10)
    assert set(small) == {"skipped"}


def test_state_dependent_extra_residual_is_refused(pair, monkeypatch):
    monkeypatch.setattr(pair["ref"], "extra_residual", lambda u, p: 2.0 * u)
    with pytest.raises(NotImplementedError, match="state-dependent"):
        ref_quality.sparse_operator(pair["ref"], pair["ref_params"])
    pde = pair["pde"]
    monkeypatch.setattr(pde, "extra_residual", lambda u, p: 2.0 * u,
                        raising=False)
    with pytest.raises(NotImplementedError, match="state-dependent"):
        quality.sparse_operator(pde, pair["params"])
    # a load-like (state-independent) term is accepted
    monkeypatch.setattr(pde, "extra_residual",
                        lambda u, p: torch.ones_like(u), raising=False)
    quality.sparse_operator(pde, pair["params"])
