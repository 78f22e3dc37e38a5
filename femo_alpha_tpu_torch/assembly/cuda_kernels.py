"""Hand-written Hopper kernels of the shell solve path, their plain twins,
and the nvcc/ctypes loader.

K1 `cell_matvec_T` replaces the Pallas kernel
femo_alpha_tpu/assembly/pallas_kernels.py::cell_matvec_T_pallas; K2
`affine_combine` replaces ::combine_df_pallas. `constrained_matvec_T` is
K1 redesigned for the card: one whole application of the strong-BC
operator (gather, per-cell matvec, scatter and masks) in one fused pass
over the element matrices; the solve path runs it, and K1 stays for the
unconstrained operator. The CUDA sources live in `csrc/` (see the header
of each for its bound and design).

Dispatch is on each tensor's own device: a CUDA tensor launches the
kernel (and raises if the kernel cannot be built or launched), a CPU tensor
runs the plain PyTorch twin. There is no process-wide switch and no
fallback from a failed kernel to its twin.

Build: at first use, one nvcc per source compiles the sources for sm_90a,
all started together, and one more links them into a shared library with
a plain C interface under `csrc/_build/` (git-ignored), under a file lock;
it is rebuilt when a source is newer than the library. The
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
_SOURCES = ("cell_matvec.cu", "affine_combine.cu", "constrained_matvec.cu")
_LIB_NAME = "libfemo_kernels.so"
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_LOCK = threading.Lock()
_LIB = None

# launches of each kernel since the last reset_launch_counts(), and those
# of its f32 build among them; the plain twins never count
_LAUNCHES = {"cell_matvec_T": 0, "affine_combine": 0,
             "constrained_matvec_T": 0}
_LAUNCHES_F32 = dict(_LAUNCHES)
_BUILD_INFO = {}


def launch_counts():
    """Kernel launches (not twin calls) since the last reset."""
    return dict(_LAUNCHES)


def launch_counts_f32():
    """The launches of launch_counts() that read f32 matrices: the f32
    builds, and the fused operator's f32-matrix, f64-vector build."""
    return dict(_LAUNCHES_F32)


def reset_launch_counts():
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0
        _LAUNCHES_F32[k] = 0


def _count(name, dtype):
    _LAUNCHES[name] += 1
    if dtype == torch.float32:
        _LAUNCHES_F32[name] += 1


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


def _run(procs, what):
    """Wait for every (name, Popen) and raise on the first failure."""
    logs, failed = [], None
    for name, proc in procs:
        out, _ = proc.communicate(timeout=600)
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0 and failed is None:
            failed = f"{what} {name} failed ({proc.returncode}):\n{out}"
    if failed:
        raise RuntimeError(failed)
    return "".join(logs)


def _build(lib_path):
    nvcc, t0 = _nvcc(), time.perf_counter()
    tag = f".tmp{os.getpid()}"
    objs = [os.path.join(_BUILD_DIR, s[:-3] + tag + ".o") for s in _SOURCES]
    compiles = [
        (src, subprocess.Popen(
            [nvcc, _ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-c", "-o", obj, os.path.join(_CSRC, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src, obj in zip(_SOURCES, objs)]
    try:
        log = _run(compiles, "nvcc")
        tmp = lib_path + tag
        log += _run([(_LIB_NAME, subprocess.Popen(
            [nvcc, _ARCH, "-shared", "-o", tmp, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))],
            "nvcc link")
    finally:
        for _, proc in compiles:
            if proc.poll() is None:
                proc.kill()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, lib_path)
    _BUILD_INFO.update(seconds=time.perf_counter() - t0, log=log,
                       library=lib_path)


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
        for name in ("femo_constrained_matvec_T_f64",
                     "femo_constrained_matvec_T_f32",
                     "femo_constrained_matvec_T_f32f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp] * 7 + [i64] * 4 + [vp]
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
# the fused operator's builds by (vector dtype, matrix dtype)
_FUSED = {(torch.float64, torch.float64): "f64",
          (torch.float32, torch.float32): "f32",
          (torch.float64, torch.float32): "f32f64"}


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
    _count("cell_matvec_T", Ae_T.dtype)
    return y


# --------------------------------------------------------------------------
# The fused constrained operator (K1 redesigned for the card)
# --------------------------------------------------------------------------


def gather_sum(yc, inv):
    """Dof pass: out[d] = the sum of yc.flatten()[inv[d, k]] over k in table
    order, starting from zero; padding (-1) adds nothing. With the tables
    of spaces/space.py::lane_tables it equals the space's scatter_add_T."""
    flat = torch.cat([yc.reshape(-1), yc.new_zeros(1)])
    idx = torch.where(inv >= 0, inv, flat.shape[0] - 1)
    g = flat.index_select(0, idx.reshape(-1)).view(inv.shape)
    out = torch.zeros_like(g[:, 0])
    for k in range(g.shape[1]):
        out = out + g[:, k]
    return out


def constrained_matvec_T_plain(Ae_T, x, free, dofmap_T, inv):
    """Plain twin of the fused operator, pass by pass: the cell pass
    yc = (Ae_T * (free * x)[dofmap_T][None]).sum(1), the dof pass over
    inv, then the mask and the identity on constrained dofs; in the
    vectors' dtype (f32 matrices with f64 vectors are read in f64)."""
    Ae_T = Ae_T.to(free.dtype)
    v = (free * x).index_select(0, dofmap_T.reshape(-1))
    yc = (Ae_T * v.view(dofmap_T.shape)[None]).sum(1)
    return free * gather_sum(yc, inv) + (1.0 - free) * x


def constrained_matvec_T(Ae_T, free, dofmap_T, inv):
    """The operator x -> free*A(free*x) + (1-free)*x of lane-major element
    matrices Ae_T (nd, nd, nc), a 0/1 mask `free` (n,) and the int32 tables
    dofmap_T (nd, nc) and inv (n, w) of spaces/space.py::lane_tables. The
    vectors take free's dtype: Ae_T's (f64 or f32), or f64 with f32
    matrices (the f32-stored operator, applied in f64 arithmetic).

    Everything is checked once, here. On CPU tensors the operator is the
    plain twin; on CUDA tensors each application is one torch.empty and
    one C call that launches the two passes of csrc/constrained_matvec.cu
    on the stream that is current now. Solver-facing and forward only:
    inputs that require grad are refused."""
    if Ae_T.dim() != 3 or Ae_T.shape[0] != Ae_T.shape[1] or free.dim() != 1:
        raise ValueError(f"constrained_matvec_T: Ae_T {tuple(Ae_T.shape)}, "
                         f"free {tuple(free.shape)}")
    nd, _, nc = Ae_T.shape
    n = free.shape[0]
    if (tuple(dofmap_T.shape) != (nd, nc) or inv.dim() != 2
            or inv.shape[0] != n):
        raise ValueError(f"constrained_matvec_T: tables "
                         f"{tuple(dofmap_T.shape)}, {tuple(inv.shape)} for "
                         f"Ae_T {tuple(Ae_T.shape)} and {n} dofs")
    if Ae_T.dtype not in _SUFFIX or (free.dtype, Ae_T.dtype) not in _FUSED:
        raise TypeError(f"constrained_matvec_T: Ae_T {Ae_T.dtype}, free "
                        f"{free.dtype} (need both float32 or float64, or "
                        "float32 matrices with float64 vectors)")
    if dofmap_T.dtype != torch.int32 or inv.dtype != torch.int32:
        raise TypeError(f"constrained_matvec_T: tables {dofmap_T.dtype}, "
                        f"{inv.dtype} (need int32)")
    if torch.is_grad_enabled() and (Ae_T.requires_grad or free.requires_grad):
        raise RuntimeError("constrained_matvec_T has no autograd rule")
    tensors = (Ae_T, free, dofmap_T, inv)
    if all(t.device.type == "cpu" for t in tensors):
        A = Ae_T.to(free.dtype)  # read in the vectors' dtype, once
        return lambda x: constrained_matvec_T_plain(A, x, free, dofmap_T,
                                                    inv)
    _require_kernel_inputs("constrained_matvec_T", (Ae_T,), Ae_T.dtype)
    _require_kernel_inputs("constrained_matvec_T", (free,), free.dtype)
    for t in (dofmap_T, inv):
        if t.device != Ae_T.device or not t.is_contiguous():
            raise ValueError(f"constrained_matvec_T: table on {t.device} "
                             f"(need contiguous on {Ae_T.device})")
    return _ConstrainedMatvecT(Ae_T, free, dofmap_T, inv)


class _ConstrainedMatvecT:
    """The CUDA operator of constrained_matvec_T: pointers, sizes, the C
    function and the stream are resolved once; the cell-value scratch
    (nd, nc) is reused by every application (all of them run on one
    stream, in order)."""

    def __init__(self, Ae_T, free, dofmap_T, inv):
        dev = Ae_T.device
        if dev.index != torch.cuda.current_device():
            raise ValueError(f"constrained_matvec_T: tensors on {dev}, but "
                             f"the current device is cuda:"
                             f"{torch.cuda.current_device()}")
        nd, _, nc = Ae_T.shape
        n, w = inv.shape
        if nd * nc >= 2 ** 31 or n >= 2 ** 31:
            raise ValueError(f"constrained_matvec_T: {nd}x{nc} cell values "
                             f"or {n} dofs overflow the int32 tables")
        if free.device != dev:
            raise ValueError(f"constrained_matvec_T: free on {free.device}, "
                             f"Ae_T on {dev}")
        self.lib = load_library()
        self.fn = getattr(self.lib, "femo_constrained_matvec_T_"
                          + _FUSED[(free.dtype, Ae_T.dtype)])
        self.yc = torch.empty((nd, nc), dtype=free.dtype, device=dev)
        self.tensors = (Ae_T, free, dofmap_T, inv)  # keep the pointers alive
        self.ptrs = (Ae_T.data_ptr(), free.data_ptr(), dofmap_T.data_ptr(),
                     inv.data_ptr(), self.yc.data_ptr())
        self.sizes = (nd, nc, n, w)
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        self.n, self.dtype, self.device = n, free.dtype, dev
        self.matrix_dtype = Ae_T.dtype

    def __call__(self, x):
        if (x.shape != (self.n,) or x.dtype != self.dtype
                or x.device != self.device or not x.is_contiguous()):
            raise ValueError(f"constrained_matvec_T: x {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}, need contiguous "
                             f"({self.n},) {self.dtype} on {self.device}")
        y = torch.empty(self.n, dtype=self.dtype, device=self.device)
        a, f, dm, iv, yc = self.ptrs
        rc = self.fn(a, x.data_ptr(), f, dm, iv, yc, y.data_ptr(),
                     *self.sizes, self.stream)
        if rc:
            _check(self.lib, rc, "constrained_matvec_T")
        _count("constrained_matvec_T", self.matrix_dtype)
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
    _count("affine_combine", B.dtype)
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
