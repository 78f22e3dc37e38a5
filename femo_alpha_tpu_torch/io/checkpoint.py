"""Checkpoint / warm-start persistence (port of
femo_alpha_tpu/io/checkpoint.py, the same .npz layout): one compressed
npz file of named arrays (designs, states, histories) plus a JSON-able
metadata dict stored as the uint8 array `__metadata__`. Tensors are saved
from wherever they lie; loading gives numpy arrays."""

from __future__ import annotations

import json

import numpy as np
import torch


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path, arrays: dict, metadata: dict | None = None):
    payload = {k: _host(v) for k, v in arrays.items()}
    payload["__metadata__"] = np.frombuffer(
        json.dumps(metadata or {}).encode(), dtype=np.uint8)
    np.savez_compressed(path, **payload)


def load_checkpoint(path):
    """-> (arrays dict of numpy arrays, metadata dict)."""
    data = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
    meta = {}
    arrays = {}
    for k in data.files:
        if k == "__metadata__":
            meta = json.loads(bytes(data[k]).decode())
        else:
            arrays[k] = data[k]
    return arrays, meta
