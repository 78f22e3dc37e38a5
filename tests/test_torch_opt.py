"""The optimization layer of the port on the CPU, against the JAX
package: OptimizationProblem / SLSQP (vector constraints, a wing thickness
study), the csdl operation contracts (StateOperation, OutputOperation,
OutputFieldOperation) on a small strong-BC plate, and the npz checkpoint.

Inputs are made with numpy from a seed, as the JAX package's side was
made; f64 throughout. The JAX package's results are pinned by
`tools/opt_reference_digits.py tests` (tests/reference_digits/opt.npz,
scipy 1.17.0), which runs it with its FEMO_* solver flags unset
(FEMO_MG_F32, FEMO_LANE_MAJOR, FEMO_HOSTLOOP, FEMO_CG_DF, FEMO_OP_STORAGE)
and jitted as these tests once called it; the checkpoint test calls the
reference's reader and writer (host numpy) live.
Tolerances: 1e-10 for the SLSQP solutions of the analytic problems and
for the contract products at one state, 1e-9 for the two packages' dense
solves, 1e-8 for the wing study's first iterate and 1e-6 for its later
ones (each test says why)."""

import os

import numpy as np
import pytest
import torch

from femo_alpha_tpu.io import load_checkpoint as ref_load
from femo_alpha_tpu.io import save_checkpoint as ref_save

from femo_alpha_tpu_torch.csdl_opt import (
    OutputFieldOperation,
    OutputOperation,
    StateOperation,
)
from femo_alpha_tpu_torch.io import load_checkpoint, save_checkpoint
from femo_alpha_tpu_torch.mesh import createRectangleMesh, createWingShellMesh
from femo_alpha_tpu_torch.models import RMShellModel
from femo_alpha_tpu_torch.opt import SLSQP, OptimizationProblem

REF_NPZ = os.path.join(os.path.dirname(__file__), "reference_digits",
                       "opt.npz")


class Out:
    pass


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


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
def digits():
    with np.load(REF_NPZ) as z:
        return {k: z[k] for k in z.files}


def _vector_problem(case):
    """tests/test_opt_vector.py's two problems."""
    if case == "lower":
        def ev(dv):
            out = Out()
            out.obj = torch.sum(dv["x"] ** 2)
            out.con = dv["x"]
            return out

        def build(prob):
            prob.add_design_variable("x", np.array([5.0, 5.0, 5.0]))
            prob.set_objective("obj")
            prob.add_constraint("con", lower=np.array([1.0, 2.0, 3.0]))
        return ev, build, 100

    def ev(dv):
        x = dv["x"]
        out = Out()
        out.obj = torch.sum((x - 2.0) ** 2)
        out.eqs = torch.stack([x[0] + x[1], x[2]])
        out.x3 = x[3]
        return out

    def build(prob):
        prob.add_design_variable("x", np.zeros(4))
        prob.set_objective("obj")
        prob.add_constraint("eqs", equals=np.array([1.0, 0.5]))
        prob.add_constraint("x3", upper=0.0)
    return ev, build, 200


@pytest.mark.parametrize("case", ["lower", "equality_and_upper"])
def test_vector_constraints_match_reference(case, digits):
    """A vector lower bound; a vector equality beside a scalar upper bound:
    the same x* to 1e-10 and the same nit / nfev / njev as the reference."""
    ev, build, maxiter = _vector_problem(case)
    prob = OptimizationProblem(ev, device="cpu")
    build(prob)
    dvs, res = prob.solve(maxiter=maxiter, report=False)
    assert res.success
    assert dvs["x"].dtype == torch.float64
    assert _rel(dvs["x"], digits[f"vector_{case}_x"]) <= 1e-10
    assert [res.nit, res.nfev, res.njev] == \
        digits[f"vector_{case}_counts"].tolist()
    assert len(prob.history) == res.nit
    # SLSQP, the reference's name for the loop, runs the same loop
    again = OptimizationProblem(ev, device="cpu")
    build(again)
    dvs2, res2 = SLSQP(again, {"maxiter": maxiter, "ftol": 1e-9}).solve()
    assert torch.equal(dvs2["x"], dvs["x"]) and res2.nit == res.nit


def test_problem_defaults_to_the_card(monkeypatch):
    """Without device=, OptimizationProblem takes the card, and raises
    where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        OptimizationProblem(lambda dv: dv)
    assert OptimizationProblem(lambda dv: dv, device="cpu").device.type \
        == "cpu"


@pytest.fixture(scope="module")
def plate():
    """An 8x4 strong-BC plate (dense solve path), its inputs in FE order
    and the seeded generator the tests go on drawing from (in the order
    tools/opt_reference_digits.py draws)."""
    def bc(x):
        return x[:, 0] < 1e-12

    mesh = createRectangleMesh(8, 4, (0, 0), (2.0, 1.0), "quad", gdim=3)
    port = RMShellModel(mesh, device="cpu", shell_bc_func=bc,
                        element_wise_material=True, PENALTY_BC=False)
    rng = np.random.default_rng(0)
    nel, nn = mesh.n_cells, mesh.n_nodes
    f = np.zeros(3 * nn)
    f[2::3] = 5e3
    inputs = {"thickness": 0.02 + 0.01 * rng.random(nel), "F_solid": f,
              "E": 7e10 * (1 + 0.1 * rng.random(nel)),
              "nu": np.full(nel, 0.3), "uhat": np.zeros(3 * nn)}
    return dict(port=port, inputs=inputs, rng=rng)


def test_state_operation_matches_reference(plate, digits):
    """The four-method contract against the reference's operations. The
    products dR/dp^T lam ('rev') and dR/dp . dp ('fwd') at one and the
    same state, to 1e-10 (measured: <= 1.3e-12); the solves (the forward
    solve and apply_inverse_jacobian both ways) to 1e-9: two dense f64
    factorizations of this thin plate (h ~ 0.02) agree to ~1e-10 (measured
    9.6e-11 for u, 6.7e-11 for lam), which the products then carry."""
    inputs, rng = plate["inputs"], plate["rng"]
    op = StateOperation(plate["port"].fea, "disp_solid")
    u = op.evaluate(inputs)
    assert _rel(u, digits["state_u"]) <= 1e-9
    g_u = rng.standard_normal(u.shape[0])
    lam = op.apply_inverse_jacobian(g_u, "rev")
    assert _rel(lam, digits["state_lam"]) <= 1e-9
    tangents = {k: rng.standard_normal(np.shape(v))
                for k, v in inputs.items()}
    tangents["uhat"] = np.zeros_like(inputs["uhat"])
    dr = op.compute_jacvec_product(inputs, "fwd", tangents)
    du = op.apply_inverse_jacobian(dr, "fwd")
    assert _rel(du, digits["state_du"]) <= 1e-9
    # the adjoint identity g_u . du = lam . dR within the port
    assert abs(float(torch.dot(torch.as_tensor(g_u), du))
               / float(torch.dot(lam, dr)) - 1.0) <= 1e-10
    # the products at the reference's state
    op._last = (torch.as_tensor(digits["state_u"]), op._last[1], None)
    lam_r = torch.as_tensor(digits["state_lam"])
    d_in = op.compute_jacvec_product(inputs, "rev", lam_r)
    for k in d_in:
        assert _rel(d_in[k], digits[f"state_d_in_{k}"]) <= 1e-10, k
    dr = op.compute_jacvec_product(inputs, "fwd", tangents)
    assert _rel(dr, digits["state_dr"]) <= 1e-10


def test_output_operations_match_reference(plate, digits):
    """OutputOperation (compliance) value and partials, and
    OutputFieldOperation (the DG1 von Mises field) value and vjp, at the
    reference's state, to 1e-10."""
    inputs, rng = plate["inputs"], plate["rng"]
    vals = dict(inputs, disp_solid=digits["state_u"])
    op = OutputOperation(plate["port"].fea, "compliance")
    assert abs(float(op.compute(vals))
               / float(digits["output_compliance"]) - 1.0) <= 1e-10
    g = op.compute_derivatives(vals)
    for k in ("disp_solid", "thickness"):
        assert _rel(g[k], digits[f"output_d_{k}"]) <= 1e-10, k
    fop = OutputFieldOperation(plate["port"].fea, "stress")
    s = fop.compute(vals)
    assert _rel(s, digits["output_stress"]) <= 1e-10
    ct = rng.standard_normal(s.shape[0])
    wrt = ["disp_solid", "thickness", "E"]
    v = fop.compute_vjp(vals, ct, wrt)
    for k in wrt:
        assert _rel(v[k], digits[f"output_vjp_{k}"]) <= 1e-10, k


def test_wing_thickness_opt_history_matches_reference(digits):
    """tests/test_wing_opt.py's study (6x12 generated wing, penalty root
    clamp, min mass s.t. aggregated stress) at maxiter=3, against the
    reference jitted as that test runs it: the same nit / nfev / njev, one
    model evaluation per design point, the objective at the first iterate
    to 1e-8 and at every iterate to 1e-6. The trajectory parts below 1e-8
    after the first iterate, and not by a fault: the packages' constraint
    gradients agree to 4.3e-10 (two dense f64 solves of the beta = 1e15
    penalty system), and the port against itself with its constraint
    gradient perturbed by a relative 4e-10 moves the second iterate's
    objective by 4-5e-8 (SLSQP's QP subproblem amplifies it). Measured:
    1.6e-11, 1.6e-10, 4.2e-8 at the three iterates."""
    mesh = createWingShellMesh(n_chord=6, n_span=12, rib_stations=(6,),
                               shuffle_seed=3)
    nel, nn = mesh.n_cells, mesh.n_nodes
    span = float(np.max(mesh.coords[:, 1]))
    eta = np.clip(np.asarray(mesh.coords[:, 1]) / span, 0.0, 1.0)
    pressure = np.zeros((nn, 3))
    pressure[:, 2] = 2000.0 * np.sqrt(1.0 - eta ** 2)
    base = dict(E=np.full(nel, 69e9), nu=np.full(nel, 0.33),
                density=np.full(nel, 2700.0))
    h0 = 0.006
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 1] < 1e-9,
                         element_wise_material=True, record=False,
                         device="cpu")

    def ev(dv):
        return model.evaluate(pressure, thickness=dv["thickness"],
                              is_pressure=True, **base)

    out0 = ev({"thickness": np.full(nel, h0)})
    mass0 = float(out0.mass)
    agg0 = float(out0.aggregated_stress)
    prob = OptimizationProblem(ev, device="cpu")
    prob.add_design_variable("thickness", h0 * np.ones(nel), lower=0.002,
                             upper=0.02)
    prob.add_constraint("aggregated_stress", upper=1.10 * agg0,
                        scaler=1.0 / agg0)
    prob.set_objective("mass", scaler=1.0 / mass0)
    _, res = prob.solve(maxiter=3, ftol=1e-8, report=False)
    hist, hist_r = prob.history, digits["wing_history"]
    assert len(hist) == len(hist_r) == 3
    assert _rel(hist[:1], hist_r[:1]) <= 1e-8
    assert _rel(hist, hist_r) <= 1e-6
    assert [res.nit, res.nfev, res.njev] == digits["wing_counts"].tolist()
    assert prob.counts["evaluate"] == res.nfev


def test_checkpoint_round_trip(tmp_path):
    """save_checkpoint / load_checkpoint: tensors and arrays with metadata
    come back equal, and the file is the reference's layout (each package
    reads the other's)."""
    arrays = {"thickness": torch.linspace(0.001, 0.02, 7,
                                          dtype=torch.float64),
              "history": np.arange(4.0), "mask": np.array([1, 0, 1])}
    meta = {"iteration": 3, "note": "wing"}
    save_checkpoint(tmp_path / "a", arrays, meta)
    for load in (load_checkpoint, ref_load):
        got, m = load(tmp_path / "a.npz")
        assert m == meta and sorted(got) == sorted(arrays)
        np.testing.assert_array_equal(got["thickness"],
                                      arrays["thickness"].numpy())
        np.testing.assert_array_equal(got["mask"], arrays["mask"])
    ref_save(str(tmp_path / "b"), {"x": np.ones(3)}, {"k": 1})
    got, m = load_checkpoint(str(tmp_path / "b"))
    assert m == {"k": 1} and np.array_equal(got["x"], np.ones(3))


def test_record_option_and_unported_modal_inputs():
    """record=False (what every optimization example passes) and
    record=True are accepted; the flag is stored, as the reference stores
    it. The mesh-motion input of the modal path, once unported, is
    accepted: a zero node_disp gives the eigenvalues of no motion."""
    mesh = createRectangleMesh(4, 2, (0, 0), (2.0, 1.0), "quad", gdim=3)
    kw = dict(shell_bc_func=lambda x: x[:, 0] < 1e-12,
              element_wise_material=True, PENALTY_BC=False, device="cpu")
    model = RMShellModel(mesh, record=False, **kw)
    assert model.record is False
    assert RMShellModel(mesh, record=True, **kw).record is True
    nel = mesh.n_cells
    args = (np.full(nel, 0.1), np.full(nel, 1e9), np.zeros(nel),
            np.ones(nel))
    zero = np.zeros((mesh.n_nodes, 3))
    lam = model.evaluate_modal(*args, n_modes=2).eigenvalues.detach()
    assert torch.equal(model.evaluate_modal(
        *args, n_modes=2, node_disp=zero).eigenvalues.detach(), lam)
    assert torch.equal(model.modal_eigenvalues(
        *args, n_modes=2, node_disp=zero).detach(), lam)
