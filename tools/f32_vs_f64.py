"""The JAX package's f32 solver configuration against the port's f64
default, on one CUDA card, workload by workload:

    python tools/f32_vs_f64.py [case ...]

cases (all by default):
- headline: LibraryBench(128, 32) (62,886 dofs, MG on 3 levels), f64 and
  built under FEMO_MG_F32=1;
- scale: LibraryBench(512, 128) (988,806 dofs, MG on 5 levels), the same
  two, with the nodal error against tests/data/golden_u_512x128_strong.npz;
- band: the 18x66 penalty wing's assembled system (36,162 dofs; h 0.006,
  E 69e9, nu 0.33), BandCholPrecond in f64 and with dtype=float32, each a
  factor and a CG solve (tol 1e-8) of a seeded right-hand side;
- amg: the 10x24 wing with the band guard forced low (AMGPrecondFactory),
  f64 and with the factory's dtype=float32;
- transient: PlateSim 40x20 over 5 steps of benchmarks.gust_history,
  element-wise thickness 0.1, the step MG in f64 and from
  build_platesim_mg(dtype=float32), simulate + backward of the total
  strain energy.

Each (case, precision) runs in a process of its own, so that its peak
device memory is its own: a first call, then three warm calls (each from
zero: no warm start), the device operations and device milliseconds of
one more warm call (torch.profiler), the Krylov iterations, the peak
device memory. One JSON line each, with the card's name and power limit
from nvidia-smi.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CASES = ("headline", "scale", "band", "amg", "transient")


def _device_busy(fn):
    """(device operations, device ms) of one call of fn (CUDA trace)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA]
    return len(ns), sum(ns) / 1e6


def _bench_case(nx, ny):
    import torch

    from femo_alpha_tpu_torch.benchmarks import LibraryBench

    b = LibraryBench(nx=nx, ny=ny)

    def run():
        b.model.model._last_states = {}
        th = b.th0.clone().requires_grad_(True)
        out = b.model.evaluate(b.f, th, b.E, b.nu, b.rho)
        out.compliance.backward()
        torch.cuda.synchronize()
        return {"u": out.disp_solid.detach(), "J": float(out.compliance)}

    def iters():
        return {k: v["passes"] for k, v in b.pde.last_info.items()}

    return run, iters


def _band_case(f32):
    import numpy as np
    import torch

    from femo_alpha_tpu_torch.assembly.assemble import element_matrices
    from femo_alpha_tpu_torch.mesh import createWingShellMesh
    from femo_alpha_tpu_torch.models.rm_shell.pde import RMShellPDE
    from femo_alpha_tpu_torch.solvers import band as B
    from femo_alpha_tpu_torch.solvers.krylov import cg_solve
    from femo_alpha_tpu_torch.solvers.linear import _sum_of_blocks

    mesh = createWingShellMesh(n_chord=18, n_span=66, rib_stations=(22, 44))
    pde = RMShellPDE(mesh, element_wise_material=True)
    nel, n = mesh.n_cells, pde.W.n_dofs
    kw = dict(dtype=torch.float64, device="cuda")
    p = {"thickness": torch.full((nel,), 0.006, **kw),
         "E": torch.full((nel,), 69e9, **kw),
         "nu": torch.full((nel,), 0.33, **kw),
         "uhat": torch.zeros(3 * mesh.n_nodes, **kw),
         "F_solid": torch.zeros(3 * mesh.n_nodes, **kw)}
    ff = pde.make_penalty_facet_form(lambda x: np.abs(x[:, 1]) < 1e-9)
    z = torch.zeros(n, **kw)
    with torch.no_grad():
        ops = [element_matrices(pde.make_residual_form(), z, p)
               .permute(1, 2, 0).contiguous(), ff.element_ops(z, p)]
    mv = _sum_of_blocks(list(zip(ops, [pde.W, ff.block])),
                        torch.ones(n, **kw))
    band = B.BandCholPrecond(pde.W, [pde.W.dofmap, ff.block.dofmap],
                             dtype=torch.float32 if f32 else None)
    rhs = torch.as_tensor(np.random.default_rng(1).standard_normal(n), **kw)
    info = {}

    def run():
        with torch.no_grad():
            st = band.setup(ops)
            x, inf = cg_solve(mv, rhs, M=lambda v: band.apply(st, v),
                              tol=1e-8, maxiter=60)
            torch.cuda.synchronize()
        info.update(iters=inf["iters"], shifted=st["shifted"])
        return {"u": x}

    return run, lambda: dict(info)


def _amg_case(f32):
    import numpy as np
    import torch

    from femo_alpha_tpu_torch.mesh import createWingShellMesh
    from femo_alpha_tpu_torch.models import RMShellModel

    os.environ["FEMO_BAND_MEM_GB"] = "0.000001"
    mesh = createWingShellMesh(n_chord=10, n_span=24, rib_stations=(12,),
                               shuffle_seed=3)
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 1] < 1e-9,
                         element_wise_material=True)
    os.environ.pop("FEMO_BAND_MEM_GB")
    pde = model.fea.states["disp_solid"].pde
    if f32:
        pde._pc.dtype = torch.float32
    nel, nn = mesh.n_cells, mesh.n_nodes
    f = np.zeros(3 * nn)
    f[2::3] = 200.0

    def run():
        model.model._last_states = {}
        th = torch.full((nel,), 0.2, dtype=torch.float64, device="cuda",
                        requires_grad=True)
        out = model.evaluate(f, th, np.full(nel, 4.32e8), np.zeros(nel),
                             np.full(nel, 100.0))
        out.compliance.backward()
        torch.cuda.synchronize()
        return {"u": out.disp_solid.detach(), "J": float(out.compliance)}

    def iters():
        return {k: v["passes"] for k, v in pde.last_info.items()}

    return run, iters


def _transient_case(f32):
    import torch

    from femo_alpha_tpu_torch.benchmarks import gust_history
    from femo_alpha_tpu_torch.mesh import createRectangleMesh
    from femo_alpha_tpu_torch.models.dynamic_rm_shell import PlateSim
    from femo_alpha_tpu_torch.models.dynamic_rm_shell.mg import (
        build_platesim_mg,
    )

    mesh = createRectangleMesh(40, 20, (0, 0), (10.0, 2.0), "quad", gdim=3)
    sim = PlateSim(mesh, E=4.32e8, nu=0.0, rho=100.0, dt=0.01, Nsteps=5,
                   element_wise_thickness=True)
    if f32:
        sim.mg = build_platesim_mg(sim, dtype=torch.float32)
    fh = gust_history(mesh.n_nodes, 5, sim.dt)

    def run():
        th = torch.full((sim.num_var,), 0.1, dtype=torch.float64,
                        device="cuda", requires_grad=True)
        e = sim.strain_energy_history(sim.simulate(th, fh), th).sum()
        e.backward()
        torch.cuda.synchronize()
        return {"J": float(e.detach())}

    return run, lambda: [k for _, k in sim.solve_log]


def child(case, f32, warm):
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if case in ("headline", "scale"):
        if f32:
            os.environ["FEMO_MG_F32"] = "1"
        run, iters = _bench_case(*((128, 32) if case == "headline"
                                   else (512, 128)))
        os.environ.pop("FEMO_MG_F32", None)
    else:
        run, iters = {"band": _band_case, "amg": _amg_case,
                      "transient": _transient_case}[case](f32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run()
    first_s = time.perf_counter() - t0
    walls = []
    for _ in range(warm):
        t0 = time.perf_counter()
        res = run()
        walls.append(time.perf_counter() - t0)
    it = iters()
    ops, dev_ms = _device_busy(run)
    med = statistics.median(walls)
    out = {"case": case, "precision": "f32" if f32 else "f64",
           "first_s": first_s, "warm_s": walls, "warm_median_s": med,
           "iters": it, "device_ops_per_call": ops,
           "device_ms_per_call": dev_ms, "busy_share": dev_ms / 1e3 / med,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if "J" in res:
        out["J"] = res["J"]
    golden = os.path.join(ROOT, "tests", "data",
                          "golden_u_512x128_strong.npz")
    if case == "scale":
        with np.load(golden) as z:
            ug = z["u"]
        u = res["u"].cpu().numpy()
        out["nodal_vs_golden"] = float(np.linalg.norm(u - ug)
                                       / np.linalg.norm(ug))
    print("RESULT " + json.dumps(out), flush=True)


def main():
    args = sys.argv[1:]
    if args and args[0] == "--child":
        return child(args[1], args[2] == "f32", 3)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    env = {k: v for k, v in os.environ.items()
           if k not in ("FEMO_MG_F32", "FEMO_OP_STORAGE", "FEMO_BAND_MEM_GB")}
    for case in args or CASES:
        for prec in ("f64", "f32"):
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", case,
                 prec], env=env, capture_output=True, text=True)
            lines = [ln for ln in run.stdout.splitlines()
                     if ln.startswith("RESULT ")]
            if run.returncode != 0 or not lines:
                print(json.dumps({"case": case, "precision": prec,
                                  "error": run.stderr[-3000:]}), flush=True)
                continue
            res = json.loads(lines[-1][len("RESULT "):])
            print(json.dumps({**res, "card": card.strip()}), flush=True)


if __name__ == "__main__":
    main()
