"""Where the port's entry points run: on the CUDA card unless the caller
names another device."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device):
    """`device` as a torch.device, or the CUDA card when it is None. Without
    a card and without `device` this raises: the CPU runs only when asked
    for, never as a fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "femo_alpha_tpu_torch runs on the CUDA card by default and this "
            "machine has none: pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def tensor_on(v, device, owner, dtype=torch.float64):
    """An input as a `dtype` tensor on `device`: arrays are converted; a
    tensor on another device is the caller's mistake and raises (it is
    never moved). `owner` names the object in the message."""
    if isinstance(v, torch.Tensor):
        if v.device.type != device.type or (
                device.index is not None and v.device.index != device.index):
            raise ValueError(
                f"{owner} was built on {device} but an input lies on "
                f"{v.device}: pass device= to {owner}")
        return v.to(dtype=dtype)
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
