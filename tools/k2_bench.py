#!/usr/bin/env python3
"""K2 (affine_combine) builds side by side on one card, at the shapes of
the port's paths, in f64: warm and cold-L2 device times of each build and
of the one PyTorch call of the same function (theta * B[0] for K = 1,
einsum for K = 2), beside the bytes bound, and whether every build gives
the first build's bits. "same_bytes" is PyTorch's simplest kernel that
moves the same bytes (a copy of B[0] for K = 1, B[0] + B[1] for K = 2):
what the card's memory gives a plain elementwise stream of that size.

    python tools/k2_bench.py [--source LABEL=FILE.cu ...] [--rounds N]

Each build is one K2 source with the C interface of
femo_alpha_tpu_torch/assembly/csrc/affine_combine.cu ("new", always
built): --source adds another file (for example the parent commit's
kernel, or a variant of this one). Builds compile in parallel with nvcc
into a temporary directory. Each round times every build in turn, in
the order of the command line and then reversed (A, B, B, A); the line
of each shape gives the median over rounds. Timers and the bound are
chip_smoke.py's. Needs one Hopper card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (timers and bound)
from femo_alpha_tpu_torch.assembly import cuda_kernels as ck  # noqa: E402

SOURCE = os.path.join(ROOT, "femo_alpha_tpu_torch", "assembly", "csrc",
                      "affine_combine.cu")
# (K, powers, nc): K = 1 is the transient's and modal's M, K = 2 every
# path's K (nc 4,096 slice and modal, 2,388 wing and opt, 800 transient)
SHAPES = [(1, (1,), 800), (1, (1,), 4096), (2, (1, 3), 4096),
          (2, (1, 3), 2388), (2, (1, 3), 800)]


def build(sources, tmp):
    """{label: ctypes library}, one nvcc per source, all started together."""
    nvcc, procs = ck._nvcc(), []
    for label, text in sources.items():
        src = os.path.join(tmp, f"{label}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(tmp, f"lib{label}.so")
        procs.append((label, lib, subprocess.Popen(
            [nvcc, ck._ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-shared", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for label, lib, proc in procs:
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {label} failed:\n{out}")
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        print(json.dumps({"build": label, "ptxas": regs}), flush=True)
        fn = ctypes.CDLL(lib).femo_affine_combine_f64
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn.argtypes = [vp, vp, vp, i32, ctypes.POINTER(i32), i64, i64, vp]
        fn.restype = i32
        libs[label] = fn
    return libs


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=FILE.cu")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2_bench: needs a CUDA card")
    with open(SOURCE) as f:
        sources = {"new": f.read()}
    for spec in args.source:
        label, path = spec.split("=", 1)
        with open(path) as f:
            sources[label] = f.read()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, tmp)
        g = torch.Generator(device="cuda").manual_seed(11)
        stream = torch.cuda.current_stream().cuda_stream
        for K, powers, nc in SHAPES:
            nd = 39
            B = torch.randn((K, nd, nd, nc), generator=g, device="cuda",
                            dtype=torch.float64) * 1e3
            th = 0.1 + 0.2 * torch.rand((nc,), generator=g, device="cuda",
                                        dtype=torch.float64)
            p = (ctypes.c_int * K)(*powers)

            def call(fn):
                out = torch.empty((nd, nd, nc), dtype=B.dtype, device="cuda")
                rc = fn(B.data_ptr(), th.data_ptr(), out.data_ptr(), K, p,
                        nd * nd, nc, stream)
                if rc:
                    raise SystemExit(f"k2_bench: launch failed ({rc})")
                return out

            outs = {lb: call(fn) for lb, fn in libs.items()}
            first = next(iter(outs.values()))
            same = {lb: bool(torch.equal(o, first)) for lb, o in outs.items()}
            coef = torch.stack([th ** q for q in powers])
            if K == 1:
                def lib():
                    return coef[0] * B[0]
            else:
                def lib():
                    return torch.einsum("kc,kijc->ijc", coef, B)
            out = torch.empty((nd, nd, nc), dtype=B.dtype, device="cuda")
            if K == 1:
                def same_bytes():
                    return out.copy_(B[0])
            else:
                def same_bytes():
                    return torch.add(B[0], B[1], out=out)
            timed = {lb: (lambda fn=fn: call(fn)) for lb, fn in libs.items()}
            timed["library"] = lib
            timed["same_bytes"] = same_bytes
            order = list(timed) + list(timed)[::-1]
            warm = {lb: [] for lb in timed}
            cold = {lb: [] for lb in timed}
            for _ in range(args.rounds):
                for lb in order:
                    warm[lb].append(cs.cuda_ms(timed[lb], 50))
                    cold[lb].append(cs.cuda_ms_cold(timed[lb], 30))
            b = cs.bound((K + 1) * B[0].nbytes + th.nbytes,
                         (2 * K - 1) * nd * nd * nc, "float64")
            print(json.dumps({
                "K": K, "nc": nc, "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"], "bitwise_equal_to_first": same,
                "ms": {lb: statistics.median(v) for lb, v in warm.items()},
                "ms_cold": {lb: statistics.median(v)
                            for lb, v in cold.items()},
                "ms_spread": {lb: [min(v), max(v)]
                              for lb, v in warm.items()}}), flush=True)
            del B


if __name__ == "__main__":
    main()
