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
classes ~17 of it). Bars are the reference's
(tests/test_product_sharding.py, tests/test_sharding.py): J 1e-9, u 1e-8,
gradients 1e-6 (relative 2-norms), the residual rtol 1e-9 / atol 1e-10.
The ranks must agree bit for bit, each rank must hold only its own cells
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
M = "torch_parallel_cases"
SPLIT2 = (0, 1)
SPLIT2B = (3, 4)
SPLIT2C = (6, 7)
SPLIT3 = (5, 6, 7)
DEMOS = ("residual", "shell", "shell_mg", "plate")


def _jobs():
    """Each rank's jobs, balanced by their seconds on the CPU (1
    thread per rank): the split cases on four groups, the one-rank runs
    on the ranks that are free meanwhile."""
    from femo_alpha_tpu_torch.parallel.ranks import Job

    def on(group, *jobs):
        return [Job(M, name, args, group) for name, args in jobs]

    solo = "solo"
    plate = on(SPLIT2, ("model_case", ("plate64",)), ("operator_case", ()),
               ("unsupported_case", ()), ("model_case", ("plate16",)))
    sim = on(SPLIT2B, ("sim_case", ()),
             *[("demo_case", (w,)) for w in DEMOS if w != "shell_mg"])
    wing = on(SPLIT3, ("model_case", ("wing",)))
    mg = on(SPLIT2C, ("demo_case", ("shell_mg",)))
    return {
        0: plate, 1: plate,
        2: on(solo, ("model_case", ("plate64", False, 2)),
              ("model_case", ("plate16", False)),
              *[("demo_case", (w,)) for w in DEMOS]),
        3: sim, 4: sim,
        5: wing + on(solo, ("model_case", ("wing", False)),
                     ("sim_case", (False,))),
        6: wing + mg, 7: wing + mg,
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
        "plate16": ([r[0][3], r[1][3]], r[2][1]),
        "operator": [r[0][1], r[1][1]],
        "unsupported": r[0][2],
        "sim": ([r[3][0], r[4][0]], r[5][2]),
        "wing": ([r[5][0], r[6][0], r[7][0]], r[5][1]),
        "demo_shell_mg": ([r[6][1], r[7][1]],
                          r[2][2 + DEMOS.index("shell_mg")]),
        "seconds": time.perf_counter() - t0,
    }
    for i, w in enumerate(("residual", "shell", "plate")):
        out["demo_" + w] = ([r[3][1 + i], r[4][1 + i]],
                            r[2][2 + DEMOS.index(w)])
    print(f"\n[parallel] 8 ranks spawned and every case run in "
          f"{out['seconds']:.1f} s")
    return out


@pytest.fixture(scope="module")
def ref():
    return dict(np.load(DIGITS))


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


def test_split_plain_factory_raises(runs):
    """A preconditioner that cannot split raises a named
    NotImplementedError under shard_model, never a wrong number."""
    msg = runs["unsupported"]
    assert msg is not None and "precond_factory" in msg


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

