"""Hand-written Hopper kernels of the shell solve path, their plain twins,
and the nvcc/ctypes loader.

K1 `cell_matvec_T` replaces the Pallas kernel
femo_alpha_tpu/assembly/pallas_kernels.py::cell_matvec_T_pallas; K2
`affine_combine` replaces ::combine_df_pallas. The CUDA sources live in
`csrc/` (see the header of each for its bound and design).

Dispatch is on each tensor's own device: a CUDA tensor launches the
kernel (and raises if the kernel cannot be built or launched), a CPU tensor
runs the plain PyTorch twin. There is no process-wide switch and no
fallback from a failed kernel to its twin.

Build: at first use, nvcc compiles both sources for sm_90a into one shared
library with a plain C interface under `csrc/_build/` (git-ignored), under
a file lock; it is rebuilt when a source is newer than the library. The
library is loaded with ctypes; tensors pass as `data_ptr()`s and kernels
launch on PyTorch's current stream. Nothing here touches the CUDA
toolchain at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_DIR = os.path.join(_CSRC, "_build")
_SOURCES = ("cell_matvec.cu", "affine_combine.cu")
_LIB_NAME = "libfemo_kernels.so"
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_LOCK = threading.Lock()
_LIB = None

# launches of each kernel since the last reset_launch_counts(); the plain
# twins never count
_LAUNCHES = {"cell_matvec_T": 0, "affine_combine": 0}
_BUILD_INFO = {}


def launch_counts():
    """Kernel launches (not twin calls) since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts():
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def build_info():
    """{'seconds', 'log', 'library'} of the build done by this process
    (empty when the library was already up to date)."""
    return dict(_BUILD_INFO)


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of femo_alpha_tpu_torch are "
            "built at first use on a machine with the CUDA toolkit")
    return path


def _build(lib_path):
    srcs = [os.path.join(_CSRC, s) for s in _SOURCES]
    tmp = lib_path + f".tmp{os.getpid()}"
    cmd = [_nvcc(), _ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, *srcs]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    _BUILD_INFO.update(seconds=time.perf_counter() - t0,
                       log=proc.stdout + proc.stderr, library=lib_path)


def _stale(lib_path):
    if not os.path.exists(lib_path):
        return True
    t = os.path.getmtime(lib_path)
    return any(os.path.getmtime(os.path.join(_CSRC, s)) > t
               for s in _SOURCES)


def load_library():
    """Build (if needed) and load the kernel library; raises on failure."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        os.makedirs(_BUILD_DIR, exist_ok=True)
        lib_path = os.path.join(_BUILD_DIR, _LIB_NAME)
        with open(os.path.join(_BUILD_DIR, "lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if _stale(lib_path):
                    _build(lib_path)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
        lib = ctypes.CDLL(lib_path)
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for name in ("femo_cell_matvec_T_f64", "femo_cell_matvec_T_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, i64, i64, vp]
            fn.restype = i32
        for name in ("femo_affine_combine_f64", "femo_affine_combine_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, i32, ctypes.POINTER(i32), i64, i64,
                           vp]
            fn.restype = i32
        lib.femo_cuda_error_string.argtypes = [i32]
        lib.femo_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib


def _check(lib, rc, what):
    if rc != 0:
        msg = lib.femo_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def _require_kernel_inputs(what, tensors, dtype):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if dtype not in _SUFFIX:
        raise TypeError(f"{what}: dtype {dtype} (need float32/float64)")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: mixed dtypes {t.dtype} and {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: non-contiguous input {tuple(t.shape)}")


# --------------------------------------------------------------------------
# K1: lane-major per-cell matvec
# --------------------------------------------------------------------------


def cell_matvec_T_plain(Ae_T, xc_T):
    """Plain twin of K1: y[i, c] = sum_j Ae_T[i, j, c] * xc_T[j, c]."""
    return (Ae_T * xc_T[None]).sum(1)


def cell_matvec_T(Ae_T, xc_T):
    """Lane-major per-cell matvec: Ae_T (nd, nd, nc), xc_T (nd, nc) ->
    (nd, nc). Solver-facing and forward only, like the TPU kernel: the
    adjoint solves reuse the symmetric operator, so nothing differentiates
    through it (inputs that require grad are refused)."""
    if Ae_T.dim() != 3 or xc_T.dim() != 2:
        raise ValueError(f"cell_matvec_T: shapes {tuple(Ae_T.shape)}, "
                         f"{tuple(xc_T.shape)}")
    nd, nd2, nc = Ae_T.shape
    if nd != nd2 or tuple(xc_T.shape) != (nd, nc):
        raise ValueError(f"cell_matvec_T: shapes {tuple(Ae_T.shape)}, "
                         f"{tuple(xc_T.shape)}")
    if torch.is_grad_enabled() and (Ae_T.requires_grad or xc_T.requires_grad):
        raise RuntimeError("cell_matvec_T has no autograd rule")
    if Ae_T.device.type == "cpu" and xc_T.device.type == "cpu":
        return cell_matvec_T_plain(Ae_T, xc_T)
    _require_kernel_inputs("cell_matvec_T", (Ae_T, xc_T), Ae_T.dtype)
    y = torch.empty((nd, nc), dtype=Ae_T.dtype, device=Ae_T.device)
    lib = load_library()
    fn = getattr(lib, "femo_cell_matvec_T_" + _SUFFIX[Ae_T.dtype])
    with torch.cuda.device(Ae_T.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(Ae_T.data_ptr(), xc_T.data_ptr(), y.data_ptr(), nd, nc,
                stream)
    _check(lib, rc, "cell_matvec_T")
    _LAUNCHES["cell_matvec_T"] += 1
    return y


# --------------------------------------------------------------------------
# K2: affine design combine
# --------------------------------------------------------------------------


def affine_combine_plain(B, theta, powers):
    """Plain twin of K2: the unrolled sum_k theta**p_k * B[k] over the
    lane-major basis B (K, nd, nd, nc)."""
    out = (theta ** powers[0])[None, None, :] * B[0]
    for k in range(1, len(powers)):
        out = out + (theta ** powers[k])[None, None, :] * B[k]
    return out


def _affine_combine_raw(B, theta, powers):
    if B.device.type == "cpu" and theta.device.type == "cpu":
        return affine_combine_plain(B, theta, powers)
    _require_kernel_inputs("affine_combine", (B, theta), B.dtype)
    K, nd, _, nc = B.shape
    out = torch.empty((nd, nd, nc), dtype=B.dtype, device=B.device)
    lib = load_library()
    fn = getattr(lib, "femo_affine_combine_" + _SUFFIX[B.dtype])
    p = (ctypes.c_int * K)(*powers)
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(B.data_ptr(), theta.data_ptr(), out.data_ptr(), K, p,
                nd * nd, nc, stream)
    _check(lib, rc, "affine_combine")
    _LAUNCHES["affine_combine"] += 1
    return out


class AffineCombine(torch.autograd.Function):
    """Ae = sum_k theta^p_k * B[k] with the closed-form reverse rule
    d theta_c = sum_k p_k theta_c^(p_k - 1) sum_ij B_k[i,j,c] G[i,j,c]
    (plain torch; the JAX package's Pallas combine has no reverse rule)."""

    @staticmethod
    def forward(ctx, B, theta, powers):
        ctx.save_for_backward(B, theta)
        ctx.powers = powers
        return _affine_combine_raw(B, theta, powers)

    @staticmethod
    def backward(ctx, G):
        B, theta = ctx.saved_tensors
        gB = gth = None
        if ctx.needs_input_grad[1]:
            gth = torch.zeros_like(theta)
            for k, p in enumerate(ctx.powers):
                if p != 0:
                    gth = gth + (p * theta ** (p - 1)) * (B[k] * G).sum(
                        (0, 1))
        if ctx.needs_input_grad[0]:
            gB = torch.stack([(theta ** p)[None, None, :] * G
                              for p in ctx.powers])
        return gB, gth, None


def affine_combine(B, theta, powers):
    """K2: lane-major affine combine Ae (nd, nd, nc) = sum_k theta^p_k B[k]
    for B (K, nd, nd, nc), theta (nc,), integer powers (K <= 4)."""
    powers = tuple(int(p) for p in powers)
    if B.dim() != 4 or B.shape[1] != B.shape[2] or B.shape[0] != len(powers):
        raise ValueError(f"affine_combine: basis {tuple(B.shape)} for "
                         f"powers {powers}")
    if not 1 <= len(powers) <= 4 or min(powers) < 0:
        raise ValueError(f"affine_combine: powers {powers}")
    if tuple(theta.shape) != (B.shape[3],):
        raise ValueError(f"affine_combine: theta {tuple(theta.shape)} for "
                         f"basis {tuple(B.shape)}")
    return AffineCombine.apply(B, theta, powers)
