"""FEA: problem registry + solve facade.

Port of the subset of femo_alpha_tpu/fea/fea.py that the shell model uses:
add_input / add_state (with facet forms) / add_strong_bc / add_output (a
form or a function) / add_field_output, solve, evaluate_output and
evaluate_field_output. Derivative forms are never registered: partials
come from autograd through the assembled residual inside ImplicitPDE.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..adjoint.implicit import ImplicitPDE
from ..assembly.assemble import FemForm, assemble_scalar
from ..assembly.bc import DirichletBC, combine_bcs
from ..device import resolve_device


@dataclass
class _Input:
    space: object


@dataclass
class _State:
    form: FemForm
    arguments: list
    solver_opts: dict = field(default_factory=dict)
    element_matrices_fn: Optional[Callable] = None
    facet_forms: tuple = ()
    pde: Optional[ImplicitPDE] = None


@dataclass
class _Output:
    fn: Optional[Callable]  # fn(vals) -> value, or None for a form
    arguments: list
    form: Optional[FemForm] = None


class FEA:
    """Registry of inputs / states / outputs over one mesh. `dtype` and
    `device` are those of the BC masks and of every solve; device None
    means the CUDA card."""

    def __init__(self, mesh, dtype=torch.float64, device=None):
        self.mesh = mesh
        self.dtype = dtype
        self.device = resolve_device(device)
        self.inputs: dict[str, _Input] = {}
        self.states: dict[str, _State] = {}
        self.outputs: dict[str, _Output] = {}
        self.field_outputs: dict[str, _Output] = {}
        self.bcs: list[DirichletBC] = []

    def add_input(self, name, space):
        self.inputs[name] = _Input(space)

    def add_state(self, name, residual_form: FemForm, arguments,
                  solver_opts=None, element_matrices_fn=None,
                  facet_forms=()):
        """A linear state: residual_form over the state space (plus facet
        forms, e.g. penalty BCs); arguments: the input names the residual
        reads."""
        self.states[name] = _State(residual_form, list(arguments),
                                   dict(solver_opts or {}),
                                   element_matrices_fn, tuple(facet_forms))
        self._build_pde(name)

    def add_output(self, name, form=None, arguments=(), fn=None):
        """Scalar output: either an energy-kind FemForm whose first argument
        is the field it integrates, or fn(vals) -> scalar."""
        if (form is None) == (fn is None):
            raise ValueError("add_output: give exactly one of form and fn")
        self.outputs[name] = _Output(fn, list(arguments), form)

    def add_field_output(self, name, fn, arguments=()):
        """Field output: fn(vals) -> tensor (e.g. an L2 projection)."""
        self.field_outputs[name] = _Output(fn, list(arguments))

    def add_strong_bc(self, dofs, values=0.0):
        self.bcs.append(DirichletBC(dofs, values))
        for name in self.states:
            self._build_pde(name)

    def _build_pde(self, name):
        st = self.states[name]
        free, bcv = combine_bcs(st.form.space.n_dofs, self.bcs,
                                dtype=self.dtype, device=self.device)
        opts = {"tol": 1e-12}
        opts.update(st.solver_opts)
        st.pde = ImplicitPDE(st.form, free, bcv, solver_opts=opts,
                             element_matrices_fn=st.element_matrices_fn,
                             facet_forms=st.facet_forms)

    def _get_pde(self, name) -> ImplicitPDE:
        return self.states[name].pde

    def solve(self, name, params, u0=None):
        """Differentiable solve of one state."""
        return self.states[name].pde.solve(params, u0=u0)

    def evaluate_output(self, name, vals):
        out = self.outputs[name]
        if out.form is None:
            return out.fn({k: vals[k] for k in out.arguments})
        u_name, pkeys = out.arguments[0], out.arguments[1:]
        return assemble_scalar(out.form, vals[u_name],
                               {k: vals[k] for k in pkeys})

    def evaluate_field_output(self, name, vals):
        out = self.field_outputs[name]
        return out.fn({k: vals[k] for k in out.arguments})
