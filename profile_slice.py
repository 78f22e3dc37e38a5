#!/usr/bin/env python3
"""Where the time goes in the port's slice on one GPU.

    python3 profile_slice.py [NX NY]

Drives the same slice as chip_smoke.py — RMShellModel.evaluate +
compliance.backward() on the 128x32 strong-BC cantilever plate, f64, on
the card (NX x NY for another size of the same plate, e.g. 512 128, the
scale point) — and prints, one line each:

- `first`: the first call's wall time (affine bases, MG setup, solves);
- `warm`: three warm calls' wall times, host clock, each ending in
  torch.cuda.synchronize(), and their median;
- `traced`: one more warm call under torch.profiler: its wall time, the
  device's busy time (union of the intervals of every kernel, copy and
  fill in the trace; the spans below are not device work), the idle
  share 1 - busy/wall, device ops launched, and the launches and device
  time of each kernel (the fused operator's two passes, K1, K2);
- `phases`: host and device time of the phases of that same traced call
  (record_function spans around the solver entry points; nested spans
  are included in their parents: the V-cycles sit inside cg_solve);

then the profiler's top device kernels and top host ops as tables. The
profiler slows the host, so the traced call's wall time is above the
untraced warm median, and the idle share read from it is an upper bound;
`idle_share_at_warm_median` reads the same busy time against the
untraced median instead, a lower bound.
Needs one CUDA card; builds the kernels itself (as chip_smoke.py does).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# (module, attribute path, span label)
SPANS = [
    ("femo_alpha_tpu_torch.solvers.linear", "cg_solve", "cg_solve"),
    ("femo_alpha_tpu_torch.solvers.multigrid", "GeometricMG.apply",
     "vcycle"),
    ("femo_alpha_tpu_torch.solvers.multigrid", "GeometricMG.setup",
     "mg_setup"),
    ("femo_alpha_tpu_torch.adjoint.implicit", "assemble_residual",
     "residual_assembly"),
    ("femo_alpha_tpu_torch.adjoint.implicit", "ImplicitPDE._prepare_aux",
     "prepare_aux"),
    ("femo_alpha_tpu_torch.assembly.affine", "element_matrices",
     "affine_element_matrices"),
]
# report name -> substring of the device kernel's name
KERNELS = {"cmv_cell_pass": "cmv_cell_pass_kernel",
           "cmv_dof_pass": "cmv_dof_pass_kernel",
           "cell_matvec_T": "cell_matvec_T_kernel",
           "affine_combine": "affine_combine_kernel"}


def _label_spans(spans=SPANS):
    """Wrap each entry point of `spans` in a record_function span."""
    import functools
    import importlib

    import torch

    for mod_name, attr, label in spans:
        owner = importlib.import_module(mod_name)
        *path, name = attr.split(".")
        for p in path:
            owner = getattr(owner, p)
        fn = getattr(owner, name)

        def wrapped(*a, _fn=fn, _label=label, **k):
            with torch.profiler.record_function(_label):
                return _fn(*a, **k)

        setattr(owner, name, functools.wraps(fn)(wrapped))


def _busy_us(intervals):
    busy, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def main():
    if len(sys.argv) not in (1, 3):
        raise SystemExit(f"profile_slice: takes no arguments or NX NY, got "
                         f"{sys.argv[1:]}")
    nx, ny = (int(a) for a in sys.argv[1:]) if len(sys.argv) == 3 \
        else (128, 32)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: needs a CUDA card")
    sys.path.insert(0, HERE)
    from femo_alpha_tpu_torch.assembly import cuda_kernels as ck
    from femo_alpha_tpu_torch.mesh import createRectangleMesh
    from femo_alpha_tpu_torch.models import RMShellModel

    _label_spans()
    ck.load_library()
    mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad", gdim=3)
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 0] < 1e-12,
                         element_wise_material=True, PENALTY_BC=False,
                         device="cuda")
    pde = model.fea.states["disp_solid"].pde
    nel, nn = mesh.n_cells, mesh.n_nodes
    kw = dict(dtype=torch.float64, device="cuda")
    f = torch.zeros(3 * nn, **kw)
    f[2::3] = 2.0
    E, nu = torch.full((nel,), 4.32e8, **kw), torch.zeros(nel, **kw)
    rho = torch.full((nel,), 100.0, **kw)

    def call(scale):
        th = torch.full((nel,), 0.2 * scale, **kw).requires_grad_(True)
        t0 = time.perf_counter()
        out = model.evaluate(f, th, E, nu, rho)
        out.compliance.backward()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def iters():
        return {k: v["iters"] for k, v in pde.last_info.items()}

    print("first " + json.dumps({"wall_s": call(1.0), "iters": iters()}),
          flush=True)
    warm = [call(1.0 + 0.01 * (i + 1)) for i in range(3)]
    print("warm " + json.dumps({"wall_s": warm,
                                "median_s": statistics.median(warm),
                                "iters": iters()}), flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = call(1.04)
    labels = {label for _, _, label in SPANS}
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and e.name not in labels]
    if not dev:
        raise SystemExit("profile_slice: the trace holds no device op "
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
        "wall_s": wall, "device_busy_s": busy, "idle_share": 1 - busy / wall,
        "idle_share_at_warm_median": 1 - busy / statistics.median(warm),
        "device_ops": len(dev), "iters": iters(), "kernels": kern}),
        flush=True)

    ka = prof.key_averages()
    phases = {}
    for e in ka:
        if e.key in labels and e.device_type == DeviceType.CPU:
            phases[e.key] = {"count": e.count,
                             "host_ms": e.cpu_time_total / 1e3,
                             "device_ms": e.device_time_total / 1e3}
    print("phases " + json.dumps(phases), flush=True)
    print(ka.table(sort_by="self_device_time_total", row_limit=20,
                   max_name_column_width=60), flush=True)
    print(ka.table(sort_by="self_cpu_time_total", row_limit=15,
                   max_name_column_width=60), flush=True)


if __name__ == "__main__":
    main()
