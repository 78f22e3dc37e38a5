#!/usr/bin/env python3
"""Where the time goes in the port's transient shell on one GPU.

    python3 tools/profile_transient.py

The workload of chip_smoke.py's `transient` phase (PlateSim, the 40x20
gust of tools/transient_bench.py, f64, MG-PCG step solves, on the card).
Prints, one line each:

- `warm`: one warm forward (simulate_outputs under no_grad, 50 steps)
  untraced: wall time, step solves, CG iterations, host ms per CG
  iteration;
- `traced`: a 5-step window of the same simulation (the first 5 steps of
  the gust, a PlateSim with Nsteps=5 and otherwise the same inputs), one
  warm forward under torch.profiler: wall time, the device's busy time
  (union of the intervals of every kernel, copy and fill), the idle share
  1 - busy/wall, device ops per step and per CG iteration, and the
  launches and device time of the fused operator's two passes and K2;
- `phases`: host and device time of spans around cg_solve, the V-cycle,
  the MG setup and the per-step energy, in that traced window;

then the profiler's top device kernels and top host ops. The profiler
slows the host, so the traced idle share is an upper bound. Needs one
CUDA card; builds the kernels itself (as chip_smoke.py does).
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPANS = [
    ("femo_alpha_tpu_torch.models.dynamic_rm_shell.plate_sim", "cg_solve",
     "cg_solve"),
    ("femo_alpha_tpu_torch.solvers.multigrid", "GeometricMG.apply",
     "vcycle"),
    ("femo_alpha_tpu_torch.solvers.multigrid", "GeometricMG.setup",
     "mg_setup"),
    ("femo_alpha_tpu_torch.models.dynamic_rm_shell.plate_sim",
     "PlateSim.strain_energy", "step_energy"),
]


def main():
    if len(sys.argv) > 1:
        raise SystemExit(f"profile_transient: takes no arguments, got "
                         f"{sys.argv[1:]}")
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_transient: needs a CUDA card")
    sys.path.insert(0, ROOT)
    from chip_smoke import _gust
    from profile_slice import KERNELS, _busy_us, _label_spans
    from femo_alpha_tpu_torch.assembly import cuda_kernels as ck
    from femo_alpha_tpu_torch.mesh import createRectangleMesh
    from femo_alpha_tpu_torch.models.dynamic_rm_shell import PlateSim

    _label_spans(SPANS)
    ck.load_library()
    mesh = createRectangleMesh(40, 20, (0, 0), (10.0, 2.0), "quad", gdim=3)
    kw = dict(E=4.32e8, nu=0.0, rho=100.0, dt=0.01,
              element_wise_thickness=True, device="cuda")
    fh = torch.as_tensor(_gust(mesh.n_nodes, 50, 0.01), device="cuda")
    th = torch.full((mesh.n_cells,), 0.1, dtype=torch.float64,
                    device="cuda")

    def forward(sim, f):
        t0 = time.perf_counter()
        with torch.no_grad():
            sim.simulate_outputs(th, f)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    sim = PlateSim(mesh, Nsteps=50, **kw)
    forward(sim, fh)  # bases, first MG setup
    wall = forward(sim, fh)
    its = [k for _, k in sim.solve_log]
    print("warm " + json.dumps({
        "wall_s": wall, "solves": len(its), "cg_iters": sum(its),
        "host_ms_per_cg_iter": wall / sum(its) * 1e3}), flush=True)

    win = PlateSim(mesh, Nsteps=5, **kw)
    forward(win, fh[:6])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = forward(win, fh[:6])
    its = sum(k for _, k in win.solve_log)
    labels = {label for _, _, label in SPANS}
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and e.name not in labels]
    if not dev:
        raise SystemExit("profile_transient: the trace holds no device op "
                         "(no CUPTI); time with CUDA events instead")
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in dev]) / 1e6
    kern = {}
    for k, sym in KERNELS.items():
        ev = [e for e in dev if sym in e.name]
        kern[k] = {"launches": len(ev),
                   "device_ms": sum(e.time_range.elapsed_us()
                                    for e in ev) / 1e3}
    print("traced " + json.dumps({
        "steps": 5, "wall_s": wall, "device_busy_s": busy,
        "idle_share": 1 - busy / wall, "device_ops": len(dev),
        "device_ops_per_step": len(dev) / 5, "cg_iters": its,
        "device_ops_per_cg_iter": len(dev) / its, "kernels": kern}),
        flush=True)
    ka = prof.key_averages()
    phases = {}
    for e in ka:
        if e.key in labels and e.device_type == DeviceType.CPU:
            phases[e.key] = {"count": e.count,
                             "host_ms": e.cpu_time_total / 1e3,
                             "device_ms": e.device_time_total / 1e3}
    print("phases " + json.dumps(phases), flush=True)
    print(ka.table(sort_by="self_device_time_total", row_limit=15,
                   max_name_column_width=60), flush=True)
    print(ka.table(sort_by="self_cpu_time_total", row_limit=15,
                   max_name_column_width=60), flush=True)


if __name__ == "__main__":
    main()
