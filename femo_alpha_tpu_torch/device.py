"""Where the port's entry points run: on the CUDA card unless the caller
names another device."""

from __future__ import annotations

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
