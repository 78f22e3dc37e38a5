"""The port's benchmark surface on the CPU: LibraryBench on a 32x16 plate
(8,118 dofs, the CG + geometric-MG path) against the JAX package's
LibraryBench digits at the same size (tools/bench_reference_digits.py);
`python -m femo_alpha_tpu_torch.bench` printing bench.py's JSON keys, and
raising without a card unless the CPU is asked for; WingBench and
TransientBench at small sizes returning their scripts' keys."""

import json
import os
import subprocess
import sys

import pytest
import torch

from femo_alpha_tpu_torch import bench
from femo_alpha_tpu_torch.benchmarks import (
    GOLDEN_BAR,
    LibraryBench,
    TransientBench,
    WingBench,
    quality_verdict,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# femo_alpha_tpu.benchmarks.LibraryBench(nx=32, ny=16) on the CPU, f64
# (tools/bench_reference_digits.py)
REF_J, REF_J_BAR = 4.386987530542165e-03, 1e-8
REF_GRAD, REF_GRAD_BAR = 1.408726651074086e-03, 1e-6

# the keys of femo_alpha_tpu.benchmarks.LibraryBench.timed_run's dict
LIBRARY_KEYS = {"wall_s", "compile_s", "n_dofs", "iters_fwd", "iters_adj",
                "solver_stats", "res_fwd", "res_adj", "res_floor", "tip", "J",
                "grad_norm", "assembly_s", "assembly_latency_s",
                "assembly_stream_s", "assembly_mdof_s",
                "assembly_stream_mdof_s"}
# the keys of bench.py's JSON line
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "compile_s",
              "rel_res", "res_floor", "quality", "assembly_mdof_s",
              "assembly_stream_mdof_s", "workload", "nodal_err_vs_direct",
              "scale_point"}


@pytest.fixture(scope="module")
def plate():
    b = LibraryBench(nx=32, ny=16, device="cpu")
    return b, b.timed_run(repeats=1)


def test_library_bench_returns_the_reference_keys(plate):
    b, out = plate
    assert LIBRARY_KEYS <= set(out)
    assert out["n_dofs"] == b.n_dofs == 8118
    assert out["iters_fwd"] > 0 and out["iters_adj"] > 0
    stats = json.loads(out["solver_stats"])
    assert sum(stats["forward"]["passes"]) == out["iters_fwd"]
    assert b.last_u.shape == (b.n_dofs,)
    # CPU tensors take the kernels' twins: no launch is counted
    assert set(out["launches"].values()) == {0}


def test_library_bench_matches_reference_digits(plate):
    _, out = plate
    assert abs(out["J"] / REF_J - 1.0) <= REF_J_BAR
    assert abs(out["grad_norm"] / REF_GRAD - 1.0) <= REF_GRAD_BAR
    assert quality_verdict(out["res_fwd"], out["res_floor"]) == "OK"


@pytest.mark.parametrize("rel,floor,nodal,want", [
    (1e-9, 1e-10, None, "OK"),       # within the bar
    (3e-8, 2e-8, None, "OK"),        # at the floor, the floor above the bar
    (3e-8, 1e-9, None, "FAIL"),
    (3e-8, 1e-9, 1e-9, "OK"),        # the nodal bar decides
    (1e-6, 2e-7, 1e-7, "FAIL"),
])
def test_quality_verdict_is_bench_gate(rel, floor, nodal, want):
    assert quality_verdict(rel, floor, nodal) == want


@pytest.mark.parametrize("nodal,ok", [(1.303e-7, True), (3e-7, False)])
def test_scale_point_holds_nodal_to_the_golden_bar(plate, nodal, ok):
    """The scale point's line gates its nodal error against the golden at
    GOLDEN_BAR, apart from bench.py's quality gate (which it passes here
    by the residual floor)."""
    _, out = plate
    sc = dict(out, setup_s=0.0, nodal_err_vs_direct=nodal,
              res_fwd=1e-8, res_adj=1e-8, res_floor=1e-6)
    sp = bench.scale_point(sc)
    assert sp["quality"] == "OK" and sp["golden_bar"] == GOLDEN_BAR
    assert sp["golden_ok"] is ok


def test_bench_cli_prints_bench_keys():
    env = dict(os.environ, FEMO_BENCH_NX="16", FEMO_BENCH_NY="4",
               FEMO_BENCH_SKIP_SCALE="1", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "femo_alpha_tpu_torch.bench", "plate",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert BENCH_KEYS <= set(line)
    assert line["quality"] == "OK" and line["backend"] == "cpu"
    assert line["metric"] == "rm_shell_fwd_adjoint_1146dofs_wall"
    assert line["nodal_err_vs_direct"] <= 1e-8
    assert "skipped" in line["scale_point"]


def test_baseline_is_the_ports_cpu_wall_of_the_headline():
    """vs_baseline divides a committed CPU wall of the 128x32 headline,
    which names the CPU and torch's thread count; no other size has one."""
    wall = bench.stored_cpu_wall(128, 32, "strong")
    assert wall is not None and wall > 0
    assert bench.stored_cpu_wall(16, 4, "strong") is None
    with open(bench.BASELINE_FILE) as f:
        note = json.load(f)["note"]
    assert "torch threads" in note and "family" in note


def test_bench_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bench.main(["plate"])


def test_wing_bench_returns_its_keys():
    out = WingBench(n_chord=6, n_span=10, rib_stations=(5,),
                    device="cpu").run(repeats=1)
    assert {"metric", "value", "unit", "n_cells", "backend", "compile_s",
            "precond", "solver_stats", "rel_res", "res_floor",
            "nodal_err_vs_direct", "quality"} <= set(out)
    assert out["metric"].startswith("wing_fwd_adjoint_")
    assert out["quality"] == "OK"


def test_transient_bench_returns_its_keys():
    out = TransientBench(nx=8, ny=4, nsteps=3, device="cpu").run(repeats=1)
    assert {"metric", "value", "unit", "mode", "fwd_wall_s", "backend",
            "compile_s", "total_strain_energy", "grad_norm", "rel_res",
            "res_floor", "quality"} <= set(out)
    assert out["metric"].endswith("_3steps_wall")
    assert out["quality"] == "OK"
