"""Output operations: the explicit-operation contract (port of
femo_alpha_tpu/csdl_opt/output_operation.py)."""

from __future__ import annotations

import torch

from ..device import tensor_on


def _tensors(fea, vals, owner):
    return {k: tensor_on(x, fea.device, owner, fea.dtype)
            for k, x in vals.items()}


def _leaves(fea, vals, names, owner):
    v = _tensors(fea, vals, owner)
    leaves = {k: v[k].detach().requires_grad_(True) for k in names}
    v.update(leaves)
    return v, leaves


class OutputOperation:
    """Scalar output: compute + compute_derivatives (autograd through the
    assembled functional)."""

    def __init__(self, fea, output_name):
        self.fea = fea
        self.output_name = output_name

    def compute(self, vals: dict):
        return self.fea.evaluate_output(
            self.output_name, _tensors(self.fea, vals, "OutputOperation"))

    def compute_derivatives(self, vals: dict, wrt=None):
        out = self.fea.outputs[self.output_name]
        names = list(out.arguments) if wrt is None else list(wrt)
        with torch.enable_grad():
            v, leaves = _leaves(self.fea, vals, names, "OutputOperation")
            y = self.fea.evaluate_output(self.output_name, v)
            gs = torch.autograd.grad(y, list(leaves.values()),
                                     allow_unused=True)
        return {k: torch.zeros_like(leaves[k]) if g is None else g
                for k, g in zip(names, gs)}


class OutputFieldOperation:
    """Field output (e.g. the projected von Mises stress); its vjp comes
    from autograd through the field map."""

    def __init__(self, fea, output_name):
        self.fea = fea
        self.output_name = output_name

    def compute(self, vals: dict):
        return self.fea.evaluate_field_output(
            self.output_name,
            _tensors(self.fea, vals, "OutputFieldOperation"))

    def compute_vjp(self, vals: dict, cotangent, wrt):
        wrt = list(wrt)
        with torch.enable_grad():
            v, leaves = _leaves(self.fea, vals, wrt, "OutputFieldOperation")
            y = self.fea.evaluate_field_output(self.output_name, v)
            ct = tensor_on(cotangent, self.fea.device, "OutputFieldOperation",
                           y.dtype)
            gs = torch.autograd.grad(y, list(leaves.values()), ct,
                                     allow_unused=True)
        return {k: torch.zeros_like(leaves[k]) if g is None else g
                for k, g in zip(wrt, gs)}
