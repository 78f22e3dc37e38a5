"""Recorder: per-optimizer-iteration state recording (port of
femo_alpha_tpu/io/recorder.py): each recorded variable gets an XDMF time
series keyed by the optimizer iteration. Values are recorded detached, as
host copies; a value seen inside a torch.func transform (vmap, grad,
jacfwd, vjp) is skipped, as the JAX recorder skips tracers."""

from __future__ import annotations

import torch

from .xdmf import XDMFWriter, _host


def _in_transform(values):
    return (isinstance(values, torch.Tensor)
            and torch._C._functorch.is_functorch_wrapped_tensor(values))


class Recorder:
    def __init__(self, path, mesh):
        self.path = str(path)
        self.mesh = mesh
        self.writers = {}
        self.opt_iter = 0

    def record(self, name, values, center="Node"):
        if _in_transform(values):
            return
        if name not in self.writers:
            self.writers[name] = XDMFWriter(
                f"{self.path}/record_{name}.xdmf", self.mesh)
        self.writers[name].write_function(
            name, _host(values), time=float(self.opt_iter), center=center)

    def step(self):
        self.opt_iter += 1

    def close(self):
        for w in self.writers.values():
            w.close()
