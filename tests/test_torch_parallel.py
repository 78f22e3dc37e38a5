"""The port's multi-device product path (femo_alpha_tpu_torch/parallel/) on
the CPU: ranks spawned once for the file (parallel.ranks.RankPool, gloo,
a file:// rendezvous under a temporary directory), every case run by the
jobs of tests/torch_parallel_cases.py.

Each case splits a model over 2 ranks (the wing over 3, so that the cell
ranges are unequal) with shard_model and is held two ways: against the
port's one-rank (unsplit) run of the same model, which another rank runs
meanwhile, and against the JAX package's 8-device shard_model run at the
same seeded inputs, pinned in tests/reference_digits/parallel.npz by
`FEMO_PLATFORM=cpu FEMO_SETUP_CACHE=0 FEMO_COMPILE_CACHE=0 python
tools/parallel_reference_digits.py` (~25 min, the eager demo
classes ~17 of it) and, for modal analysis (the 8x4 plate's dense route
and LOBPCG, the 64x16 plate's LOBPCG on MG) and the plain precond_factory
shell_mg_precond_factory (32x8), in tests/reference_digits/
parallel_modal.npz by tools/parallel_modal_reference_digits.py (~4 min);
those cases are also held to the JAX package's unsplit digits that
tests/test_torch_modal.py and tests/test_torch_api.py read. User-built
pieces without a split hook (an element_matrices_fn without .shard, a
bare-make_Ae MG level, a split-protocol preconditioner without
shard_state) are held to their one-rank runs. Bars are the reference's
(tests/test_product_sharding.py, tests/test_sharding.py): J 1e-9, u 1e-8,
gradients 1e-6 (relative 2-norms), the residual rtol 1e-9 / atol 1e-10;
the modal cases take tests/test_torch_modal.py's (1e-12 dense
eigenvalues, 1e-10 LOBPCG ones, 1e-8 gradients, max-abs relative) and the
factory tests/test_torch_api.py's (the state 1e-9 max abs). The ranks must agree bit for bit, each rank must hold only its own cells
of the fine Ae, the affine basis and every MG level's basis, and each
unsplit run must give, bit for bit, what the port gave before the split
existed (tests/reference_digits/parallel_unsplit.npz, written by
`tools/parallel_unsplit_digits.py` from a checkout of that commit, with
the thread counts the ranks here use: two for the one-rank 64x16 plate,
the longest job, one elsewhere).
"""

import os
import sys
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
DIGITS = os.path.join(HERE, "reference_digits", "parallel.npz")
UNSPLIT = os.path.join(HERE, "reference_digits", "parallel_unsplit.npz")
MODAL_DIGITS = os.path.join(HERE, "reference_digits", "parallel_modal.npz")
MODAL_8X4 = os.path.join(HERE, "reference_digits", "modal_8x4.npz")
API = os.path.join(HERE, "reference_digits", "api.npz")
M = "torch_parallel_cases"
SPLIT2 = (0, 1)
SPLIT2B = (3, 4)
SPLIT2C = (6, 7)
SPLIT3 = (5, 6, 7)
DEMOS = ("residual", "shell", "shell_mg", "plate")
PIECES = ("emf", "mg_level", "pc")


def _jobs():
    """Each rank's jobs, balanced by their seconds on the CPU (1
    thread per rank): the split cases on four groups, the one-rank runs
    on the ranks that are free meanwhile (2 and 5)."""
    from femo_alpha_tpu_torch.parallel.ranks import Job

    def on(group, *jobs):
        return [Job(M, name, args, group) for name, args in jobs]

    solo = "solo"
    plate = on(SPLIT2, ("model_case", ("plate64",)), ("operator_case", ()),
               ("model_case", ("plate16",)), ("modal_case", ("modal8",)),
               ("factory_case", ()), ("pieces_case", ("emf",)))
    sim = on(SPLIT2B, ("sim_case", ()),
             *[("demo_case", (w,)) for w in DEMOS],
             *[("pieces_case", (w,)) for w in PIECES[1:]])
    wing = on(SPLIT3, ("model_case", ("wing",)))
    modal = on(SPLIT2C, ("modal_case", ("modal64",)))
    return {
        0: plate, 1: plate,
        2: on(solo, ("model_case", ("plate64", False, 2)),
              ("model_case", ("plate16", False)),
              *[("demo_case", (w,)) for w in DEMOS],
              ("modal_case", ("modal8", False)), ("factory_case", (False,)),
              *[("pieces_case", (w, False)) for w in PIECES]),
        3: sim, 4: sim,
        5: wing + on(solo, ("model_case", ("wing", False)),
                     ("sim_case", (False,)),
                     ("modal_case", ("modal64", False))),
        6: wing + modal, 7: wing + modal,
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results, keyed by case: (split rank results, solo)."""
    from femo_alpha_tpu_torch.parallel.ranks import RankPool

    sys.path.insert(0, HERE)  # the ranks import torch_parallel_cases
    t0 = time.perf_counter()
    pool = RankPool(8, tmp_path_factory.mktemp("rendezvous"),
                    groups=[SPLIT2, SPLIT2B, SPLIT2C, SPLIT3], threads=1)
    try:
        r = pool.run(_jobs())
    finally:
        pool.close()
    out = {
        "plate64": ([r[0][0], r[1][0]], r[2][0]),
        "plate16": ([r[0][2], r[1][2]], r[2][1]),
        "operator": [r[0][1], r[1][1]],
        "modal8": ([r[0][3], r[1][3]], r[2][6]),
        "factory": ([r[0][4], r[1][4]], r[2][7]),
        "emf": ([r[0][5], r[1][5]], r[2][8]),
        "sim": ([r[3][0], r[4][0]], r[5][2]),
        "wing": ([r[5][0], r[6][0], r[7][0]], r[5][1]),
        "modal64": ([r[6][1], r[7][1]], r[5][3]),
        "seconds": time.perf_counter() - t0,
    }
    for i, w in enumerate(DEMOS):
        out["demo_" + w] = ([r[3][1 + i], r[4][1 + i]], r[2][2 + i])
    for i, w in enumerate(PIECES[1:]):
        out[w] = ([r[3][5 + i], r[4][5 + i]], r[2][9 + i])
    print(f"\n[parallel] 8 ranks spawned and every case run in "
          f"{out['seconds']:.1f} s")
    return out


@pytest.fixture(scope="module")
def ref():
    return dict(np.load(DIGITS))


@pytest.fixture(scope="module")
def ref_modal():
    """The JAX package's 8-device digits of the modal and factory cases,
    its unsplit modal digits (tests/test_torch_modal.py's) and its
    unsplit plain-factory digits (tests/test_torch_api.py's)."""
    out = {k: v for k, v in np.load(MODAL_DIGITS).items()}
    out.update({"unsplit_" + k: v for k, v in np.load(MODAL_8X4).items()})
    out.update({"unsplit_" + k: v for k, v in np.load(API).items()})
    return out


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / \
        np.linalg.norm(np.asarray(b))


def _ranks_agree(split, keys):
    for k in keys:
        for other in split[1:]:
            assert np.array_equal(np.asarray(split[0][k]),
                                  np.asarray(other[k])), k


def _held_own_cells(split, n_ranks):
    """Each rank holds only its cells of every cell-indexed array, and the
    ranks' ranges tile the cell axis."""
    keys = split[0]["held"].keys()
    assert keys
    for k in keys:
        counts = [s["held"][k][0] for s in split]
        nc = split[0]["held"][k][1]
        assert sum(counts) == nc and max(counts) < nc, (k, counts)
        assert max(counts) - min(counts) <= 1, (k, counts)
    assert len(split) == n_ranks


@pytest.mark.parametrize("case,route,n_ranks", [
    ("plate64", "mg", 2), ("plate16", "dense", 2), ("wing", "band", 3)])
def test_split_model_matches_one_rank_and_reference(runs, ref, case, route,
                                                    n_ranks):
    """RMShellModel under shard_model on the MG, dense and band routes:
    compliance, displacement and d compliance / d thickness against the
    one-rank run and the JAX package's 8-device run; bit-identical ranks;
    each rank holds only its own cells."""
    split, solo = runs[case]
    assert all(s["route"] == route for s in split) and solo["route"] == route
    _ranks_agree(split, ("J", "u", "g", "iters"))
    _held_own_cells(split, n_ranks)
    s = split[0]
    for other, name in ((solo, "one rank"),
                        ({"J": float(ref[case + "_J"]), "u": ref[case + "_u"],
                          "g": ref[case + "_g"]}, "JAX")):
        assert abs(s["J"] - other["J"]) < 1e-9 * abs(other["J"]), name
        assert _rel(s["u"], other["u"]) < 1e-8, name
        assert _rel(s["g"], other["g"]) < 1e-6, name
    assert s["all_reduce"] > 0


def test_split_platesim_matches_one_rank_and_reference(runs, ref):
    """PlateSim 16x4 on the step MG, 2 steps: the summed strain energy and
    its thickness gradient; the bases of K and A and of every MG level on
    each rank's cells only; the same CG iterations as one rank."""
    split, solo = runs["sim"]
    assert all(s["route"] == "mg" for s in split)
    _ranks_agree(split, ("J", "g", "w", "solve_log"))
    _held_own_cells(split, 2)
    s = split[0]
    assert s["solve_log"] == solo["solve_log"]
    for J, g, name in ((solo["J"], solo["g"], "one rank"),
                       (float(ref["sim_J"]), ref["sim_g"], "JAX")):
        assert abs(s["J"] - J) < 1e-9 * abs(J), name
        assert _rel(s["g"], g) < 1e-6, name
    assert _rel(s["w"], solo["w"]) < 1e-8


def test_split_operator_counts_the_identity_once(runs):
    """The split fused operator equals the whole one exactly on the
    constrained dofs (x there: the (1 - free) x term once over the ranks)
    and to rounding on the free ones; both ranks hold the same vector."""
    a, b = runs["operator"]
    assert a["cells"] == (0, 32) and b["cells"] == (32, 64)
    assert np.array_equal(a["y_split"], b["y_split"])
    dead = a["free"] == 0.0
    assert dead.any()
    assert np.array_equal(a["y_split"][dead], a["y_whole"][dead])
    assert np.array_equal(a["y_split"][dead], a["x"][dead])
    free = ~dead
    assert _rel(a["y_split"][free], a["y_whole"][free]) < 1e-13
    assert a["all_reduce"] == 1


def test_demo_residual_matches(runs, ref):
    """ShardedAssembler.residual on 8x4: the ranks' cells, one all_reduce;
    against the one-rank run and the JAX package's."""
    split, solo = runs["demo_residual"]
    assert split[0]["cells"] == (0, 16) and split[1]["cells"] == (16, 32)
    _ranks_agree(split, ("r",))
    for other in (solo["r"], ref["demo_residual"]):
        np.testing.assert_allclose(split[0]["r"], other, rtol=1e-9,
                                   atol=1e-10)


@pytest.mark.parametrize("what,levels", [("shell", 0), ("shell_mg", 3),
                                         ("plate", 0)])
def test_demo_train_step_matches(runs, ref, what, levels):
    """ShardedShellStep.train_step without a preconditioner (8x2) and with
    the split MG (16x4, three levels), ShardedPlateStep.train_step (4x2,
    2 steps): value and thickness gradient against the one-rank run and
    the JAX package's."""
    split, solo = runs["demo_" + what]
    _ranks_agree(split, ("J", "g"))
    s = split[0]
    if what != "plate":
        assert s["levels"] == levels
    for J, g, name in ((solo["J"], solo["g"], "one rank"),
                       (float(ref[f"demo_{what}_J"]), ref[f"demo_{what}_g"],
                        "JAX")):
        assert abs(s["J"] - J) < 1e-9 * max(1.0, abs(J)), name
        assert _rel(s["g"], g) < 1e-6, name


@pytest.mark.parametrize("case", ["plate64", "plate16", "wing", "sim"])
def test_unsplit_results_unchanged(runs, case):
    """A model that is not split takes the path it took before the split
    existed: its results are the pinned ones, bit for bit."""
    pinned = np.load(UNSPLIT)
    solo = runs[case][1]
    assert solo["J"] == float(pinned[case + "_J"])
    assert np.array_equal(solo["g"], pinned[case + "_g"])
    key = "w" if case == "sim" else "u"
    assert np.array_equal(solo[key], pinned[f"{case}_{key}"])



def _max_rel(a, b):
    """Max-abs error over the max-abs of b (tests/test_torch_modal.py's
    measure)."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_split_modal_dense_matches_one_rank_and_reference(runs, ref_modal):
    """evaluate_modal's dense route on the 8x4 plate split over 2 ranks (K
    and M from each rank's cells, one all_reduce each): 5 eigenvalues to
    1e-12 of the one-rank run, of the JAX package's unsplit digits and of
    its 8-device ones; the first mode's modal_eigenvalues gradient in
    thickness, E, nu and density (each rank's cells, the inputs entering
    through grad_all_reduce once) to 1e-8 of all three, the modal file's
    gradient bar (the gradient is first-order in the mode, so K summed
    in another order moves it past 1e-12); the extracted modes up to
    sign; the memo; bit-identical ranks; the mass basis on each rank's
    cells."""
    split, solo = runs["modal8"]
    assert all(s["route"] == "dense" for s in split)
    _ranks_agree(split, ("dense", "modes_extracted", "lobpcg", "iterations"))
    for k in range(4):
        assert all(np.array_equal(split[0]["grads"][k], s["grads"][k])
                   for s in split[1:])
    _held_own_cells(split, 2)
    s = split[0]
    assert s["memo"] and solo["memo"]
    for want in (solo["dense"], ref_modal["unsplit_dense_eigenvalues"],
                 ref_modal["modal8_dense_eigenvalues"]):
        assert _max_rel(s["dense"], want) <= 1e-12
    for k, name in enumerate(("thickness", "E", "nu", "density")):
        for want in (solo["grads"][k], ref_modal["unsplit_grad_" + name],
                     ref_modal["modal8_grad_" + name]):
            assert _max_rel(s["grads"][k], want) <= 1e-8, name
    mx, mx_r = s["modes_extracted"], ref_modal["unsplit_dense_modes_extracted"]
    for i in range(5):
        sign = float(np.sign(np.vdot(mx[i], mx_r[i])))
        assert _max_rel(sign * mx[i], mx_r[i]) <= 1e-8
    assert s["all_reduce"] > 0


@pytest.mark.parametrize("case,route", [("modal8", "dense"),
                                        ("modal64", "mg")])
def test_split_modal_lobpcg_matches_one_rank_and_reference(runs, ref_modal,
                                                           case, route):
    """LOBPCG on a split model: K the split solve operator, M the split
    inertia operator (K2 on each rank's basis slice, the fused operator on
    its cells), preconditioned by the split solve path (the dense
    Cholesky on the 8x4 plate, 4 modes at tol 1e-10; the split MG V-cycle
    on the 64x16 plate, 3 modes at tol 1e-8): eigenvalues to 1e-10 of the
    one-rank run and of the JAX package's 8-device run (and, on 8x4, its
    unsplit digits); residual norms <= 1e-5 (tests/test_torch_modal.py's
    bar); bit-identical ranks. The iteration count is not compared: where
    a column's residual hovers at tol, one rounding-level change moves it
    (64x16: 21 split, 32 on one rank, 24 in the JAX package's run, the
    eigenvalues 5e-16 apart)."""
    split, solo = runs[case]
    assert all(s["route"] == route for s in split) and solo["route"] == route
    _ranks_agree(split, ("lobpcg", "iterations", "res_norms"))
    _held_own_cells(split, 2)
    s = split[0]
    wants = [solo["lobpcg"], ref_modal[case + "_lobpcg_eigenvalues"
                                       if case == "modal8" else
                                       case + "_eigenvalues"]]
    if case == "modal8":
        wants.append(ref_modal["unsplit_lobpcg_eigenvalues"])
    for want in wants:
        assert _max_rel(s["lobpcg"], want) <= 1e-10
    assert 0 < s["iterations"] < (100 if case == "modal8" else 200)
    assert float(np.max(s["res_norms"])) <= 1e-5
    assert s["all_reduce"] > 0


def test_split_plain_factory_matches_one_rank_and_reference(runs,
                                                            ref_modal):
    """shell_mg_precond_factory, a plain precond_factory, on the 32x8
    plate split over 2 ranks: its shard_state splits the hierarchy, whose
    every level (the fine one included) each rank builds on its cells at
    each linearization; the state to 1e-9 (max abs) of the JAX package's
    unsplit and 8-device digits and of the one-rank run, the forward CG
    iterations equal to the JAX runs', the gradient to 1e-6 of the
    one-rank run; the factory called once per linearization on every rank
    (no dense solve passes for it), each level of its state on the rank's
    cells; bit-identical ranks. The adjoint's CG count ends at its
    tolerance to rounding: 21 split, 22 on one rank; held within one."""
    split, solo = runs["factory"]
    _ranks_agree(split, ("u", "g", "iters", "calls"))
    s = split[0]
    assert all(r["plain"] for r in split) and solo["plain"]
    assert s["calls"] == solo["calls"] == 1
    for r in split:
        assert r["level_cells"] == [[(n + 1) // 2 for n in r["level_nc"]]]
    assert solo["level_cells"] == [solo["level_nc"]]
    for want in (solo["u"], ref_modal["unsplit_mg_factory_u"],
                 ref_modal["factory_u"]):
        assert float(np.abs(s["u"] - want).max()) < 1e-9
    for want in (ref_modal["unsplit_mg_factory_iters"],
                 ref_modal["factory_iters"]):
        assert [s["iters"][0]] == want.tolist()
    assert abs(s["iters"][1] - solo["iters"][1]) <= 1
    assert _rel(s["g"], solo["g"]) < 1e-6
    assert s["all_reduce"] > 0


@pytest.mark.parametrize("piece", PIECES)
def test_split_user_pieces_match_one_rank(runs, ref, piece):
    """User-built pieces without a split hook, each run whole on every
    rank as under the JAX package's GSPMD: an element_matrices_fn without
    .shard (its whole blocks cut to the rank's cells), a GeometricMG level
    with a bare make_Ae (built whole, cut) and a split-protocol
    preconditioner without shard_state (handed the whole fine block,
    gathered from the ranks' blocks): J, u and dJ/dh against the one-rank
    run and the JAX package's 8-device run of the same 16x4 plate and
    inputs (plate16; at CG tol 1e-12 the state does not depend on the
    preconditioner or the element-matrix route) at the reference's bars;
    the operator each rank holds is its own cells; bit-identical ranks."""
    split, solo = runs[piece]
    _ranks_agree(split, ("J", "u", "g", "iters", "seen"))
    s = split[0]
    whole = 16 if piece == "mg_level" else s["nel"]
    assert s["seen"] and set(s["seen"]) == {whole}
    assert set(solo["seen"]) == {whole}
    assert [r["held_Ae"] for r in split] == [s["nel"] // 2] * 2
    for other, name in ((solo, "one rank"),
                        ({"J": float(ref["plate16_J"]),
                          "u": ref["plate16_u"], "g": ref["plate16_g"]},
                         "JAX")):
        assert abs(s["J"] - other["J"]) < 1e-9 * abs(other["J"]), name
        assert _rel(s["u"], other["u"]) < 1e-8, name
        assert _rel(s["g"], other["g"]) < 1e-6, name
    assert s["all_reduce"] > 0
