"""The repo's example studies as the port's entry points
(femo_alpha_tpu_torch/examples/, one module per script under examples/),
run on the CPU through their `build` / `main` at cut study constants and
held against the JAX package's numbers for the same scripts at the same
cuts, pinned in tests/reference_digits/examples.npz by
`tools/examples_reference_digits.py tests` (with FEMO_SETUP_CACHE=0 and
FEMO_COMPILE_CACHE=0; its SLSQP histories on the scipy recorded there).

The cuts (the tool's CUTS["tests"]): SLSQP maxiter 1 (the beam study's
iterates follow rounding: its start only), the transient examples'
Nsteps 4, ex_million_dof_shell at 16x4. The c172
wing of ex_gust_response_wing takes PlateSim's Jacobi-CG route (9,831
dofs), whose ~5,400 CG iterations per step solve cost ~12 s each on one
CPU thread: it runs forward only, at 3 steps (the fewest at which the
script's gust loads the wing); its 40-step forward and adjoint are held
on the card by chip_smoke.py. ex_pav_wing_thickness_opt's 35,370-dof
band solve is held on the card too (chip_smoke.py's `opt` phase); here
its problem is built and its objective scale compared. The problems of
ex_frequency_constrained_opt and ex_aeroelastic_interface are held by
tests/test_torch_modal.py and tests/test_torch_shape.py through their
modules' `build`.

Bars: 1e-8 relative on outputs, 1e-6 on gradients and on the scaled
objective and the design at each SLSQP iterate, nit / nfev / njev equal.
"""

import importlib
import os

import numpy as np
import pytest
import scipy
import torch

REF_NPZ = os.path.join(os.path.dirname(__file__), "reference_digits",
                       "examples.npz")
OUT_BAR, GRAD_BAR, SLSQP_BAR = 1e-8, 1e-6, 1e-6


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: the tests run
    beside other workers, and multithreaded f64 solves at these sizes are
    slower than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def digits():
    with np.load(REF_NPZ) as z:
        return {k: z[k] for k in z.files}


def _ref(digits, name):
    pre = f"tests.{name}."
    return {k[len(pre):]: v for k, v in digits.items() if k.startswith(pre)}


def _module(name):
    return importlib.import_module(f"femo_alpha_tpu_torch.examples.{name}")


@pytest.fixture(scope="module")
def run():
    """run(name, argv): the example's main on the CPU at the cut, once per
    module (the von Mises test reads the lpc study's run)."""
    done = {}

    def main(name, argv):
        if name not in done:
            done[name] = _module(name).main(list(argv) + ["--device", "cpu"])
        return done[name]

    return main


# ------------------------------------------------------- the c172 wing
@pytest.fixture(scope="module")
def gust_wing():
    """ex_gust_response_wing's build and evaluate at 3 steps, forward."""
    ex = _module("ex_gust_response_wing").build(Nsteps=3, device="cpu")
    sim = ex["model"]
    with torch.no_grad():
        out = ex["evaluate"](sim.t_array)
    return ex, {k: float(v) for k, v in out.items()}, list(sim.solve_log)


def test_gust_wing_matches_reference(gust_wing, digits):
    """Total strain energy and skin mass of the c172 wing's gust response
    at 3 steps against the JAX script's."""
    ex, out, _ = gust_wing
    ref = _ref(digits, "ex_gust_response_wing")
    assert ex["model"].fe_dofs == int(ref["n_dofs"]) == 9831
    for k in ("total_strain_energy", "mass"):
        assert abs(out[k] / float(ref[k]) - 1.0) <= OUT_BAR, k


def test_gust_wing_takes_the_cg_route(gust_wing, digits):
    """The c172 wing's step solves take the Jacobi-CG route in both
    packages (9,831 dofs: PlateSim's MG needs a structured plate, and the
    JAX package's off-TPU choice is "cg" above 8,000 dofs), with the JAX
    run's CG iterations per step to within 5 % (~5,400 each follow
    rounding: chip_smoke.py's EXAMPLES_CG_SLACK, the same rule)."""
    ex, _, log = gust_wing
    ref = _ref(digits, "ex_gust_response_wing")
    assert ex["model"].solver_method == str(ref["solver_method"]) == "cg"
    assert [p for p, _ in log] == ["forward"] * 3
    got = np.array([k for _, k in log])
    want = ref["cg_iters_forward"]
    assert got.shape == want.shape == (3,)
    assert np.all(np.abs(got - want) <= 0.05 * want), (got, want)


# ----------------------------------------------------- the SLSQP studies
# name: (argv at the cut, outputs at OUT_BAR, gradients at GRAD_BAR,
# outputs at the last iterate at SLSQP_BAR)
STUDIES = {
    "ex_lpc_gust_like_opt": (
        ["--maxiter", "1", "--Nsteps", "4"],
        ("scale_0", "mass0", "max_disp0", "margins0"), (),
        ("h_bay", "max_disp", "mass", "buckling_margin")),
    "ex_tiltrotor_like_opt": (
        ["--maxiter", "1"],
        ("mass0", "aggregated_stress0", "max_disp0"), (),
        ("h_bay", "mass", "aggregated_stress", "max_disp",
         "aggregated_stress_skin", "aggregated_stress_rib")),
    "ex_lpc_static_multicase_opt": (
        ["--maxiter", "1"],
        ("mass0", "disp_limit", "plus_3g_stress0", "plus_3g_tip_disp0",
         "minus_1g_stress0", "minus_1g_tip_disp0"), (),
        ("h_bay", "mass", "plus_3g_stress", "plus_3g_tip_disp",
         "minus_1g_stress", "minus_1g_tip_disp")),
    "ex_gust_response_opt": (
        ["--maxiter", "1", "--Nsteps", "4"],
        ("total_strain_energy0", "mass0"), (),
        ("thickness", "mass", "total_strain_energy",
         "online_total_strain_energy")),
    "ex_simple_dynamic_shell_opt": (
        ["--maxiter", "1", "--Nsteps", "4", "--run_check_derivatives", "1"],
        ("total_strain_energy0", "volume0"), ("grad",), ("thickness",)),
    "ex_simple_shell": (
        ["--maxiter", "1", "--run_check_derivatives", "1"],
        ("tip", "mass0", "aggregated_stress0", "compliance0"), ("grad",),
        ("thickness",)),
    "ex_plate_shape_opt": (
        ["--maxiter", "1", "--run_check_derivatives", "0"],
        ("J0",), (), ("dy", "compliance")),
}


@pytest.mark.parametrize("name", sorted(STUDIES))
def test_study_matches_reference(name, digits, run):
    """The study's outputs at its start, its gradients where the script
    takes them outside SLSQP (with run_check_derivatives on, whose
    check_totals passes), and its SLSQP run at the cut: the scaled
    objective and the design at each iterate, nit / nfev / njev, and the
    outputs at the last iterate."""
    argv, outs, grads, final = STUDIES[name]
    ref = _ref(digits, name)
    got = run(name, argv)
    if "n_dofs" in ref:
        assert got["n_dofs"] == int(ref["n_dofs"])
    if "solver_method" in ref:
        assert got["solver_method"] == str(ref["solver_method"])
    for k in outs:
        assert _rel(got[k], ref[k]) <= OUT_BAR, (k, _rel(got[k], ref[k]))
    for k in grads:
        assert _rel(got[k], ref[k]) <= GRAD_BAR, (k, _rel(got[k], ref[k]))
    if dict(zip(argv[::2], argv[1::2])).get("--run_check_derivatives") == "1":
        assert got["check_totals_max_rel"] <= 1e-4
    assert scipy.__version__ == str(digits["scipy"])
    assert got["counts"].tolist() == ref["counts"].tolist()
    assert len(got["history"]) == len(ref["history"]) == got["counts"][0]
    assert _rel(got["history"], ref["history"]) <= SLSQP_BAR
    for x, x_ref in zip(got["designs"], ref["designs"]):
        assert _rel(x, x_ref) <= SLSQP_BAR
    for k in final:
        assert _rel(got[k], ref[k]) <= SLSQP_BAR, (k, _rel(got[k], ref[k]))


def test_platesim_von_mises_at_the_gust_peak_matches_reference(digits,
                                                                 run):
    """PlateSim.von_Mises_stress (the DG1 projection, cellwise rows) of
    the lpc wing's state at the gust peak, at h0, against the JAX
    package's field: the input of the study's bay buckling margins."""
    got = run("ex_lpc_gust_like_opt",
              STUDIES["ex_lpc_gust_like_opt"][0])["vm_peak_field0"]
    ref = _ref(digits, "ex_lpc_gust_like_opt")["vm_peak_field0"]
    assert got.shape == ref.shape and got.shape[0] % 128 == 0
    assert _rel(got, ref) <= OUT_BAR


# ------------------------------------------------------- the others
def test_beam_study_matches_reference(digits):
    """ex_thickness_opt_cantilever_beam's forward compliance and volume and
    the compliance's gradient at h = 0.1 against the JAX package's, with
    its check_totals passing. Its SLSQP path is not compared: the first
    line searches reach thicknesses where the stiffness's condition
    number passes 1e15, and the JAX package's own runs part there (jit
    against eager: 3.4e7 against 8.2e6 at the first iterate, same nit /
    nfev / njev); chip_smoke.py's `beam` phase holds the whole study to
    the OpenMDAO optimum through the module's build."""
    from femo_alpha_tpu_torch.adjoint import check_totals

    ref = _ref(digits, "ex_thickness_opt_cantilever_beam")
    mod = _module("ex_thickness_opt_cantilever_beam")
    ex = mod.build(device="cpu")
    th0 = torch.full((mod.nel,), mod.h, **ex["kw"])
    t = th0.clone().requires_grad_(True)
    out = ex["evaluate"]({"thickness": t})
    (g,) = torch.autograd.grad(out.compliance, t)
    for k, v in (("compliance0", out.compliance), ("volume0", out.volume)):
        assert _rel(float(v.detach()), ref[k]) <= OUT_BAR, k
    assert _rel(g.numpy(), ref["grad"]) <= GRAD_BAR
    assert check_totals(ex["compliance"], {"thickness": th0}, eps=1e-7,
                        directions=3) <= 1e-4


def test_modal_analysis_matches_reference(digits, tmp_path):
    """ex_modal_analysis at its 20x10: six eigenvalues and frequencies,
    d lam_1 / dh, and the first mode written as VTU into the directory
    given."""
    ref = _ref(digits, "ex_modal_analysis")
    got = _module("ex_modal_analysis").main(
        ["--out_dir", str(tmp_path), "--device", "cpu"])
    assert got["n_dofs"] == int(ref["n_dofs"])
    for k in ("eigenvalues", "frequencies"):
        assert _rel(got[k], ref[k]) <= OUT_BAR, k
    assert _rel(got["grad"], ref["grad"]) <= GRAD_BAR
    with open(got["vtu"]) as f:
        head = f.read(200)
    assert got["vtu"] == str(tmp_path / "mode1.vtu") and "VTKFile" in head


def test_million_dof_shell_matches_reference(digits):
    """ex_million_dof_shell's forward + adjoint at 16x4 against the JAX
    package's LibraryBench there."""
    ref = _ref(digits, "ex_million_dof_shell")
    got = _module("ex_million_dof_shell").main(
        ["--NX", "16", "--NY", "4", "--device", "cpu"])
    assert got["n_dofs"] == int(ref["n_dofs"])
    for k in ("J", "tip"):
        assert _rel(got[k], ref[k]) <= OUT_BAR, k
    for k in ("grad", "grad_norm"):
        assert _rel(got[k], ref[k]) <= GRAD_BAR, k


def test_pav_wing_problem_matches_reference(digits):
    """ex_pav_wing_thickness_opt's build: the 35,370-dof penalty wing on
    the band path, 2,388 thicknesses in [0.001, 0.02] from 0.005, the
    stress constraint at 503e6 / 1.5, and the objective's scale (the mass
    at h0) against the JAX package's."""
    ref = _ref(digits, "ex_pav_wing_thickness_opt")
    ex = _module("ex_pav_wing_thickness_opt").build(device="cpu")
    model, prob = ex["model"], ex["problem"]
    assert model.shell_pde.W.n_dofs == int(ref["n_dofs"]) == 35370
    assert model.band is not None and model.band.b > 0
    dv = prob.dvs["thickness"]
    assert dv["size"] == 2388 and (dv["lower"], dv["upper"]) == (0.001, 0.02)
    assert np.all(dv["init"] == 0.005)
    (con,) = prob.constraints
    assert con["name"] == "aggregated_stress"
    assert con["upper"] == 503.0e6 / 1.5 and con["scaler"] == 1.5 / 503.0e6
    assert prob.objective == "mass"
    assert abs(ex["mass0"] / float(ref["mass0"]) - 1.0) <= OUT_BAR
    assert prob.obj_scaler == 1.0 / ex["mass0"]
