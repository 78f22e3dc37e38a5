#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (femo_alpha_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one Hopper card (compute capability 9.0) and the CUDA toolkit: it
builds the port's two hand-written kernels from the sources in this
checkout, checks each against its plain PyTorch twin on the card, then
drives the RM-shell slice — RMShellModel.evaluate + compliance.backward()
on the 128x32 strong-BC cantilever plate (62,886 dofs), f64 — and checks
the result against the physics anchor, the solve-quality gate and a host
sparse direct solve of the same assembled system. Each phase prints one
line; the second-to-last lines are the kernel table (JSON) and the card
name and power limit (nvidia-smi), the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Any failed check raises, and the script exits non-zero. It imports
nothing of JAX and takes no arguments.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# pass bars (PERF.md, "End-to-end metrics")
K1_BAR = {"float32": 1e-6, "float64": 1e-14}
K2_BAR = {"float32": 1e-6, "float64": 1e-15}
K2_GRAD_BAR = 1e-12
J_ANCHOR = 4.387e-3          # compliance of the cantilever plate (f_z=2)
J_BAR = 1e-3
NODAL_BAR = 1e-7
NODAL_TARGET = 1e-8          # the repo's long-run target, printed beside


def say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def rel_norm(a, b):
    import torch

    return float(torch.linalg.norm((a - b).double())
                 / torch.linalg.norm(b.double()))


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over `reps` back-to-back calls (CUDA
    events around the whole run, after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"compute capability {cap}, need (9, 0) (Hopper, sm_90a)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say("device", name=repr(torch.cuda.get_device_name(0)),
        capability=f"{cap[0]}.{cap[1]}", torch=torch.__version__,
        cuda=torch.version.cuda, nvidia_smi=repr(card))
    return card


def phase_build(ck):
    t0 = time.perf_counter()
    ck.load_library()
    info = ck.build_info()
    regs = [ln.strip() for ln in info.get("log", "").splitlines()
            if "registers" in ln]
    say("build", seconds=f"{time.perf_counter() - t0:.2f}",
        nvcc_seconds=f"{info.get('seconds', 0.0):.2f}",
        ptxas=json.dumps(regs))


def phase_k1(ck):
    import torch

    g = torch.Generator(device="cuda").manual_seed(0)
    # (nd, nc): every nd x {4096, 65536, ragged 1000}, plus the slice's
    # coarser MG levels (1024 and 256 cells at nd = 39)
    shapes = [(nd, nc) for nd in (39, 12, 3) for nc in (4096, 65536, 1000)]
    shapes += [(39, 1024), (39, 256)]
    cases, main = [], None
    for dtype in (torch.float32, torch.float64):
        for nd, nc in shapes:
            A = torch.randn((nd, nd, nc), generator=g, device="cuda",
                            dtype=dtype)
            x = torch.randn((nd, nc), generator=g, device="cuda",
                            dtype=dtype)
            y = ck.cell_matvec_T(A, x)
            yp = ck.cell_matvec_T_plain(A, x)
            torch.cuda.synchronize()
            err = rel_norm(y, yp)
            name = str(dtype).split(".")[-1]
            if not err <= K1_BAR[name]:
                fail(f"K1 {name} nd={nd} nc={nc}: rel err {err:.3e} > "
                     f"{K1_BAR[name]:.0e}")
            reps = 200 if nc <= 4096 else 50
            ms = cuda_ms(lambda: ck.cell_matvec_T(A, x), reps)
            pms = cuda_ms(lambda: ck.cell_matvec_T_plain(A, x), reps)
            cases.append(f"{name}/{nd}/{nc}:err={err:.2e},"
                         f"ms={ms:.5f},plain_ms={pms:.5f}")
            if dtype == torch.float64 and nd == 39 and nc == 4096:
                main = dict(max_abs_err=float((y - yp).abs().max()),
                            ms=ms, plain_ms=pms)
    say("k1_cell_matvec_T", bar="f32<=1e-6,f64<=1e-14",
        cases=json.dumps(cases))
    return main


def phase_k2(ck):
    import torch

    g = torch.Generator(device="cuda").manual_seed(1)
    powers = (1, 3)
    cases, main = [], None
    for dtype in (torch.float64, torch.float32):
        for nc in (4096, 1024, 256):
            nd = 39
            B = torch.randn((2, nd, nd, nc), generator=g, device="cuda",
                            dtype=dtype) * 1e3
            th = 0.1 + 0.2 * torch.rand((nc,), generator=g, device="cuda",
                                        dtype=dtype)
            out = ck.affine_combine(B, th, powers)
            ref = ck.affine_combine_plain(B, th, powers)
            torch.cuda.synchronize()
            err = rel_norm(out, ref)
            name = str(dtype).split(".")[-1]
            if not err <= K2_BAR[name]:
                fail(f"K2 {name} nc={nc}: rel err {err:.3e} > "
                     f"{K2_BAR[name]:.0e}")
            ms = cuda_ms(lambda: ck.affine_combine(B, th, powers), 100)
            pms = cuda_ms(lambda: ck.affine_combine_plain(B, th, powers),
                          100)
            case = f"{name}/{nc}:err={err:.2e},ms={ms:.5f},plain_ms={pms:.5f}"
            if dtype == torch.float64:
                G = torch.randn((nd, nd, nc), generator=g, device="cuda",
                                dtype=dtype)
                t1 = th.clone().requires_grad_(True)
                (gk,) = torch.autograd.grad(
                    ck.affine_combine(B, t1, powers), t1, G)
                t2 = th.clone().requires_grad_(True)
                (gp,) = torch.autograd.grad(
                    ck.affine_combine_plain(B, t2, powers), t2, G)
                gerr = rel_norm(gk, gp)
                if not gerr <= K2_GRAD_BAR:
                    fail(f"K2 backward nc={nc}: rel err {gerr:.3e} > "
                         f"{K2_GRAD_BAR:.0e}")
                case += f",grad_err={gerr:.2e}"
                if nc == 4096:
                    main = dict(max_abs_err=float((out - ref).abs().max()),
                                ms=ms, plain_ms=pms)
            cases.append(case)
    say("k2_affine_combine", bar="f64<=1e-15,f32<=1e-6,grad<=1e-12",
        cases=json.dumps(cases))
    return main


def _slice_inputs(mesh, torch):
    nel, nn = mesh.n_cells, mesh.n_nodes
    kw = dict(dtype=torch.float64, device="cuda")
    f = torch.zeros(3 * nn, **kw)
    f[2::3] = 2.0
    return (f, torch.full((nel,), 4.32e8, **kw), torch.zeros(nel, **kw),
            torch.full((nel,), 100.0, **kw), torch.full((nel,), 0.2, **kw))


def phase_slice(ck):
    """The slice on the card at 128x32."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch

    from femo_alpha_tpu_torch.assembly.assemble import make_matvec_T
    from femo_alpha_tpu_torch.mesh import createRectangleMesh
    from femo_alpha_tpu_torch.models import RMShellModel

    nx, ny = 128, 32
    mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad", gdim=3)
    t0 = time.perf_counter()
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 0] < 1e-12,
                         element_wise_material=True, PENALTY_BC=False,
                         device="cuda")
    setup_s = time.perf_counter() - t0
    pde = model.fea.states["disp_solid"].pde
    n = pde.n_dofs
    f, E, nu, rho, th0 = _slice_inputs(mesh, torch)

    def forward_adjoint(th_val):
        th = th_val.clone().requires_grad_(True)
        out = model.evaluate(f, th, E, nu, rho)
        out.compliance.backward()
        torch.cuda.synchronize()
        return out, th.grad

    ck.reset_launch_counts()
    t0 = time.perf_counter()
    out, grad = forward_adjoint(th0)
    first_s = time.perf_counter() - t0
    warm = []
    for i in range(3):
        t0 = time.perf_counter()
        forward_adjoint(th0 * (1.0 + 0.01 * (i + 1)))
        warm.append(time.perf_counter() - t0)
    launches = ck.launch_counts()
    if min(launches.values()) <= 0:
        fail(f"a kernel of the path was never launched: {launches}")

    # quality at the nominal design (untimed)
    out, grad = forward_adjoint(th0)
    iters = {k: v["iters"] for k, v in pde.last_info.items()}
    with torch.no_grad():
        u = out.disp_solid.detach()
        J = float(out.compliance.detach())
        params = {"thickness": th0, "E": E, "nu": nu, "F_solid": f,
                  "uhat": torch.zeros(3 * mesh.n_nodes, dtype=torch.float64,
                                      device="cuda")}
        zero = torch.zeros_like(u)
        r0 = float(torch.linalg.norm(pde.residual(zero, params)))
        rn = float(torch.linalg.norm(pde.residual(u, params)))
        Ae = pde._assemble_ops(zero, params)[0]
        absAu = make_matvec_T(Ae.abs(), pde.form.space)(u.abs())
        rel_res = rn / r0
        res_floor = float(np.finfo(np.float64).eps) * (
            float(torch.linalg.norm(absAu)) + r0) / r0
        # host direct solve of the same assembled, constrained system
        Ae_c = Ae.permute(2, 0, 1).cpu().numpy()
        dm = pde.form.space.dofmap
        nd = dm.shape[1]
        rows = np.repeat(dm, nd, axis=1).ravel()
        cols = np.tile(dm, (1, nd)).ravel()
        K = sp.csr_matrix((Ae_c.ravel(), (rows, cols)), shape=(n, n))
        free = pde.free_mask.cpu().numpy()
        B = (sp.diags(free) @ K @ sp.diags(free)
             + sp.diags(1.0 - free)).tocsc()
        b = -pde.residual(zero, params).cpu().numpy()
    t0 = time.perf_counter()
    lu = spla.splu(B)
    ud = lu.solve(b)
    ud = ud + lu.solve(b - B @ ud)
    direct_s = time.perf_counter() - t0
    uh = u.cpu().numpy()
    nodal = float(np.linalg.norm(uh - ud) / np.linalg.norm(ud))
    tip = float(u.abs().max())
    gnorm = float(torch.linalg.norm(grad))
    finite = bool(torch.isfinite(u).all()) and bool(torch.isfinite(grad).all())
    say("slice", mesh=f"{nx}x{ny}", n_dofs=n, setup_s=f"{setup_s:.3f}",
        first_call_s=f"{first_s:.3f}",
        warm_median_s=f"{statistics.median(warm):.4f}",
        warm_s=json.dumps([round(w, 4) for w in warm]),
        compliance=f"{J:.9e}", tip=f"{tip:.9e}", grad_norm=f"{gnorm:.9e}",
        iters_fwd=iters.get("forward"), iters_adj=iters.get("adjoint"),
        rel_res=f"{rel_res:.3e}", res_floor=f"{res_floor:.3e}",
        nodal_err_vs_direct=f"{nodal:.3e}", nodal_target=f"{NODAL_TARGET:.0e}",
        direct_s=f"{direct_s:.2f}", launches=json.dumps(launches))
    if not finite or u.shape != (n,) or grad.shape != (mesh.n_cells,):
        fail("non-finite or mis-shaped displacement / gradient")
    if not abs(J / J_ANCHOR - 1.0) < J_BAR:
        fail(f"compliance {J:.6e} vs anchor {J_ANCHOR} (bar {J_BAR})")
    if not rel_res <= max(1e-8, 2.0 * res_floor):
        fail(f"rel_res {rel_res:.3e} > max(1e-8, 2*{res_floor:.3e})")
    if not nodal <= NODAL_BAR:
        fail(f"nodal error vs direct {nodal:.3e} > {NODAL_BAR:.0e}")
    return launches


def main():
    if len(sys.argv) > 1:
        fail(f"takes no arguments, got {sys.argv[1:]}")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, HERE)
    try:
        from femo_alpha_tpu_torch.assembly import cuda_kernels as ck
    except ImportError as e:
        fail(f"cannot import femo_alpha_tpu_torch from {HERE} ({e})")
    if "jax" in sys.modules:
        fail("jax was imported")
    card = phase_device()
    phase_build(ck)
    k1 = phase_k1(ck)
    k2 = phase_k2(ck)
    launches = phase_slice(ck)
    if "jax" in sys.modules:
        fail("jax was imported")
    table = [
        {"name": "cell_matvec_T", "route": "cuda",
         "source": "femo_alpha_tpu_torch/assembly/csrc/cell_matvec.cu",
         "replaces": "femo_alpha_tpu/assembly/pallas_kernels.py:41",
         "launches": launches["cell_matvec_T"], **k1},
        {"name": "affine_combine", "route": "cuda",
         "source": "femo_alpha_tpu_torch/assembly/csrc/affine_combine.cu",
         "replaces": "femo_alpha_tpu/assembly/pallas_kernels.py:148",
         "launches": launches["affine_combine"], **k2},
    ]
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
