"""Disk cache for the affine design bases (assembly/affine.py).

Port of femo_alpha_tpu/utils/diskcache.py. A basis is a pure function of
the mesh, the form, the non-design parameters and the probe scale, and its
build (probe assemblies and a verify assembly, torch.func over every cell)
is most of a large model's first call: 12.8 s of the 988k-dof scale
point's 14.2 s first call on an NVIDIA H100 (PERF.md). With the cache on,
the first process stores each basis it builds and a later process on the
same inputs loads it instead, bit for bit what the build gave.

Off unless FEMO_SETUP_CACHE=1 (the JAX package turns its cache on by
default): with it on, what a process computes would depend on what an
earlier process left on disk (a loaded basis skips the build and its
verify), and the port keeps every run's work the same unless asked.
Entries are .npz files under FEMO_SETUP_CACHE_DIR (default: a
`.femo_setup_cache` directory at the root of the checkout, which git
ignores). A key covers:

- a content hash of the package's sources that determine the values
  (assembly, elements, mesh, spaces, models, config.py), so that an edit
  invalidates every entry;
- what the caller hashes: for a basis, the mesh and dofmap, the form's
  kind, parameter names, dtype and cell constants, the element matrices
  of the first and last cell at the probe design (so every form option
  that changes them, the quadrature degrees `inplane_deg` / `shear_deg`
  and the element type included, changes the key), the non-design
  parameters, the probe scale, powers, storage, dtype, the cell range
  and the device type.

Writes go to a temporary file renamed into place, so a reader never sees
half an entry; a failed write leaves the cache cold.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

_CODE_FP = {}
_VALUE_DIRS = ("assembly", "elements", "mesh", "spaces", "models",
               "config.py")
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enabled() -> bool:
    return os.environ.get("FEMO_SETUP_CACHE") == "1"


def cache_dir() -> str:
    return os.environ.get("FEMO_SETUP_CACHE_DIR") or os.path.join(
        os.path.dirname(_PKG), ".femo_setup_cache")


def code_fingerprint() -> str:
    """A content hash of the sources under _VALUE_DIRS (once per
    process)."""
    fp = _CODE_FP.get("affine")
    if fp is None:
        h = hashlib.sha1()
        for dirpath, dirnames, filenames in sorted(os.walk(_PKG)):
            dirnames.sort()
            for fn in sorted(filenames):
                rel = os.path.relpath(os.path.join(dirpath, fn), _PKG)
                if not fn.endswith((".py", ".cu")) or \
                        not rel.startswith(_VALUE_DIRS):
                    continue
                with open(os.path.join(dirpath, fn), "rb") as f:
                    h.update(rel.encode())
                    h.update(hashlib.sha1(f.read()).digest())
        fp = _CODE_FP["affine"] = h.hexdigest()[:16]
    return fp


def _host(a):
    """A numpy array of an array or a tensor on any device."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def key(*parts) -> str:
    """A hex key of strings, numbers, numpy arrays and tensors (their
    dtype, shape and bytes)."""
    h = hashlib.sha1(code_fingerprint().encode())
    for p in parts:
        if isinstance(p, torch.Tensor):
            p = _host(p)
        if isinstance(p, np.ndarray):
            h.update(f"{p.dtype}{p.shape}".encode())
            h.update(np.ascontiguousarray(p).tobytes())
        else:
            h.update(repr(p).encode())
        h.update(b"|")
    return h.hexdigest()


def _path(kind: str, k: str) -> str:
    return os.path.join(cache_dir(), f"{kind}-{k}.npz")


def load(kind: str, k: str):
    """The arrays stored under (kind, key), or None (cache off, no entry,
    or an unreadable one)."""
    if not enabled():
        return None
    try:
        with np.load(_path(kind, k)) as z:
            return [z[f"a{i}"] for i in range(int(z["n"]))]
    except (OSError, KeyError, ValueError):
        return None


def store(kind: str, k: str, arrays) -> None:
    """Store arrays under (kind, key) when the cache is on; an error
    (disk full, a race) leaves no entry behind."""
    if not enabled():
        return
    p = _path(kind, k)
    tmp = f"{p}.tmp{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(p), exist_ok=True)
        payload = {f"a{i}": _host(a) for i, a in enumerate(arrays)}
        with open(tmp, "wb") as f:
            np.savez(f, n=np.asarray(len(arrays)), **payload)
        os.replace(tmp, p)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
