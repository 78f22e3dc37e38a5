"""The port's benchmark line: one JSON line on stdout, with the keys of the
JAX package's bench.py.

    python -m femo_alpha_tpu_torch.bench [plate|wing|transient] [--device cpu]

plate (default): `benchmarks.LibraryBench` — evaluate + compliance
backward on the FEMO_BENCH_NX x FEMO_BENCH_NY (default 128x32, 62,886
dofs) cantilever plate, FEMO_BENCH_BC strong (default, geometric MG) or
penalty; a warm optimizer iteration, median of 3. Its nodal error is a
live host SuperLU cross-check (`utils/quality.direct_crosscheck`). Then
the scale point, FEMO_BENCH_SCALE_NX x FEMO_BENCH_SCALE_NY (default
512x128, 988,806 dofs), one warm iteration in a child process with a
budget of FEMO_BENCH_SCALE_BUDGET_S seconds (default 1500), held against
the committed host-f64 golden tests/data/golden_u_<nx>x<ny>_<bc>.npz;
FEMO_BENCH_SKIP_SCALE=1 skips it, and a CPU run never runs it.

`vs_baseline` divides the port's CPU wall of the same plate, measured once
with `--device cpu` and committed in bench_baseline.json (by hand: this
program never writes the file or measures the CPU wall itself), by this
run's wall; it is null when the file has no entry for the size and BC.

wing / transient: `benchmarks.WingBench` / `TransientBench` at the
defaults of tools/wing_bench.py / tools/transient_bench.py.

Every line names the backend and the device (the card's name and power
limit from nvidia-smi), and on the card the peak device memory. The scale
point's nodal error against its golden is held to
`benchmarks.GOLDEN_BAR` (`golden_ok`). The program runs on the CUDA card;
without one it raises unless `--device cpu` asks for the CPU. It exits
non-zero, after printing its line, when the quality gate fails or the
scale point fails or misses its golden.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import sys
import time

import numpy as np
import torch

from .device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "bench_baseline.json")
WORKLOAD = "warm-start optimizer-iteration (median of 3)"
MAX_DIRECT_DOFS = 300_000


def device_name(device):
    """The card's name and power limit as nvidia-smi gives them, or the
    CPU's model and torch's thread count."""
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return smi.stdout.strip().splitlines()[device.index or 0]
    return f"{cpu_model()}, {torch.get_num_threads()} torch threads"


def cpu_model():
    """/proc/cpuinfo's model name, or its vendor, family and model numbers
    where the name is not given."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if ":" in line:
                    k, v = (x.strip() for x in line.split(":", 1))
                    info.setdefault(k, v)
    except OSError:
        pass
    name = info.get("model name", "unknown")
    if name != "unknown":
        return name
    if "vendor_id" in info:
        return (f"{info['vendor_id']} family {info.get('cpu family', '?')} "
                f"model {info.get('model', '?')}")
    return platform.processor() or platform.machine()


def stored_cpu_wall(nx, ny, bc):
    try:
        with open(BASELINE_FILE) as f:
            return json.load(f)["entries"].get(f"{nx}x{ny}:{bc}")
    except (OSError, KeyError, ValueError):
        return None


def golden_nodal(u, nx, ny, bc):
    """Nodal relative L2 error of u against the committed host-f64 direct
    golden of this plate, or None when there is none."""
    path = os.path.join(ROOT, "tests", "data",
                        f"golden_u_{nx}x{ny}_{bc}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        ug = z["u"]
    if ug.shape != np.shape(u):
        return None
    return float(np.linalg.norm(np.asarray(u) - ug) / np.linalg.norm(ug))


def run_plate(nx, ny, bc, device, repeats):
    """LibraryBench's timed_run at one size, with the model's build time,
    the peak device memory (GB, over the whole process) and the nodal
    error: against a live host SuperLU solve up to MAX_DIRECT_DOFS, else
    against the committed golden, where there is one."""
    from .benchmarks import LibraryBench
    from .utils.quality import direct_crosscheck

    t0 = time.perf_counter()
    b = LibraryBench(nx=nx, ny=ny, penalty=(bc == "penalty"), device=device)
    setup_s = time.perf_counter() - t0
    print(f"[bench] {nx}x{ny} model build {setup_s:.1f}s", file=sys.stderr,
          flush=True)
    out = b.timed_run(repeats=repeats)
    out["setup_s"] = setup_s
    if device.type == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    cc = direct_crosscheck(b.pde, b.params(b.th0), b.last_u,
                           max_dofs=MAX_DIRECT_DOFS)
    nodal = cc.get("nodal_l2", golden_nodal(b.last_u, nx, ny, bc))
    if nodal is not None:
        out["nodal_err_vs_direct"] = nodal
    return out


def _gate(out):
    """(rel_res, verdict): bench.py's quality gate."""
    from .benchmarks import quality_verdict

    rel = max(out["res_fwd"], out["res_adj"])
    return rel, quality_verdict(rel, out["res_floor"],
                                out.get("nodal_err_vs_direct"))


def run_scale_child(nx, ny, bc, budget):
    """The scale point in a child process of this module (a crash, an
    out-of-memory or a hang stays in the child; the budget kills it).
    Returns the child's result dict or {'error': ...}."""
    env = dict(os.environ, FEMO_BENCH_CHILD="1", FEMO_BENCH_NX=str(nx),
               FEMO_BENCH_NY=str(ny))
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    try:
        res = subprocess.run(
            [sys.executable, "-m", "femo_alpha_tpu_torch.bench", "plate"],
            capture_output=True, text=True, timeout=budget, env=env)
    except subprocess.TimeoutExpired:
        return {"error": f"scale point timed out after {budget}s"}
    sys.stderr.write(res.stderr[-4000:])
    for line in reversed(res.stdout.strip().splitlines()):
        try:
            d = json.loads(line)
        except json.JSONDecodeError:
            continue
        if "wall_s" in d:
            return d
    tail = " ".join(res.stderr.strip().splitlines()[-3:])[-300:]
    return {"error": f"scale child rc {res.returncode}: {tail}"}


def scale_point(sc):
    from .benchmarks import GOLDEN_BAR

    rel, verdict = _gate(sc)
    sp = {"n_dofs": sc["n_dofs"], "wall_s": round(sc["wall_s"], 4),
          "compile_s": round(sc["compile_s"], 1),
          "setup_s": round(sc["setup_s"], 1),
          "iters_fwd": sc["iters_fwd"], "iters_adj": sc["iters_adj"],
          "rel_res": float(f"{rel:.2e}"),
          "res_floor": float(f"{sc['res_floor']:.2e}"),
          "quality": verdict,
          "assembly_mdof_s": round(sc["assembly_mdof_s"], 1),
          "solver_stats": sc["solver_stats"],
          "launches": sc["launches"]}
    if "nodal_err_vs_direct" in sc:
        sp["nodal_err_vs_direct"] = float(f"{sc['nodal_err_vs_direct']:.2e}")
        sp["golden_bar"] = GOLDEN_BAR
        sp["golden_ok"] = sc["nodal_err_vs_direct"] <= GOLDEN_BAR
    if "peak_mem_gb" in sc:
        sp["peak_mem_gb"] = round(sc["peak_mem_gb"], 3)
    return sp


def plate_line(device):
    env = os.environ
    nx = int(env.get("FEMO_BENCH_NX", "128"))
    ny = int(env.get("FEMO_BENCH_NY", "32"))
    bc = env.get("FEMO_BENCH_BC", "strong")
    if bc not in ("strong", "penalty"):
        raise ValueError(f"FEMO_BENCH_BC={bc!r} (strong or penalty)")
    if env.get("FEMO_BENCH_CHILD"):
        print(json.dumps(run_plate(nx, ny, bc, device, repeats=1)),
              flush=True)
        return None
    out = run_plate(nx, ny, bc, device, repeats=3)
    rel, verdict = _gate(out)
    cpu_wall = stored_cpu_wall(nx, ny, bc)
    print(f"[bench] {device.type} {nx}x{ny} ({out['n_dofs']} dofs): wall "
          f"{out['wall_s']:.4f}s first {out['compile_s']:.2f}s iters fwd/adj "
          f"{out['iters_fwd']}/{out['iters_adj']} rel_res {rel:.2e} floor "
          f"{out['res_floor']:.2e} tip {out['tip']:.9e} J {out['J']:.9e} "
          f"|grad| {out['grad_norm']:.9e} assembly "
          f"{1e3 * out['assembly_s']:.3f}ms launches {out['launches']}",
          file=sys.stderr, flush=True)
    result = {
        "metric": f"rm_shell_fwd_adjoint_{out['n_dofs']}dofs_wall",
        "value": round(out["wall_s"], 4),
        "unit": "s",
        "vs_baseline": (round(cpu_wall / out["wall_s"], 3) if cpu_wall
                        else None),
        "compile_s": round(out["compile_s"], 1),
        "rel_res": float(f"{rel:.2e}"),
        "res_floor": float(f"{out['res_floor']:.2e}"),
        "quality": verdict,
        "assembly_mdof_s": round(out["assembly_mdof_s"], 2),
        "assembly_stream_mdof_s": round(out["assembly_stream_mdof_s"], 2),
        "workload": WORKLOAD,
        "nodal_err_vs_direct": float(f"{out['nodal_err_vs_direct']:.2e}"),
        "J": out["J"],
        "grad_norm": out["grad_norm"],
    }
    if device.type != "cuda":
        result["scale_point"] = {"skipped": "runs on the card only"}
    elif env.get("FEMO_BENCH_SKIP_SCALE"):
        result["scale_point"] = {"skipped": "FEMO_BENCH_SKIP_SCALE"}
    else:
        sc = run_scale_child(int(env.get("FEMO_BENCH_SCALE_NX", "512")),
                             int(env.get("FEMO_BENCH_SCALE_NY", "128")), bc,
                             int(env.get("FEMO_BENCH_SCALE_BUDGET_S", "1500")))
        result["scale_point"] = sc if "error" in sc else scale_point(sc)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m femo_alpha_tpu_torch.bench",
        description="The port's benchmark line (bench.py's JSON keys).")
    ap.add_argument("workload", nargs="?", default="plate",
                    choices=("plate", "wing", "transient"))
    ap.add_argument("--device", choices=("cpu",),
                    help="run on the CPU (the kernels' plain twins); "
                         "without it the program needs a CUDA card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.workload == "plate":
        result = plate_line(device)
        if result is None:
            return 0
    elif args.workload == "wing":
        from .benchmarks import WingBench

        result = WingBench(device=device).run()
    else:
        from .benchmarks import TransientBench

        result = TransientBench(device=device).run()
    result["backend"] = device.type
    result["device"] = device_name(device)
    if device.type == "cuda":
        # this process's peak; the scale point reports its child's own
        result["peak_mem_gb"] = round(
            torch.cuda.max_memory_allocated(device) / 1e9, 3)
    print(json.dumps(result), flush=True)
    sp = result.get("scale_point", {})
    ok = result["quality"] == "OK" and "error" not in sp \
        and sp.get("quality", "OK") == "OK" and sp.get("golden_ok", True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
