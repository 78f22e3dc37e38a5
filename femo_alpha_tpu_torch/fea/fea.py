"""FEA: problem registry + solve facade.

Port of the subset of femo_alpha_tpu/fea/fea.py that the shell model uses:
add_input / add_state / add_strong_bc / add_output, solve and
evaluate_output. Derivative forms are never registered: partials come from
autograd through the assembled residual inside ImplicitPDE.
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
    pde: Optional[ImplicitPDE] = None


@dataclass
class _Output:
    form: FemForm
    arguments: list


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
        self.bcs: list[DirichletBC] = []

    def add_input(self, name, space):
        self.inputs[name] = _Input(space)

    def add_state(self, name, residual_form: FemForm, arguments,
                  solver_opts=None, element_matrices_fn=None):
        """A linear state: residual_form over the state space; arguments:
        the input names the residual reads."""
        self.states[name] = _State(residual_form, list(arguments),
                                   dict(solver_opts or {}),
                                   element_matrices_fn)
        self._build_pde(name)

    def add_output(self, name, form, arguments):
        """Scalar output: an energy-kind FemForm whose first argument is
        the field it integrates."""
        self.outputs[name] = _Output(form, list(arguments))

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
                             element_matrices_fn=st.element_matrices_fn)

    def solve(self, name, params, u0=None):
        """Differentiable solve of one state."""
        return self.states[name].pde.solve(params, u0=u0)

    def evaluate_output(self, name, vals):
        out = self.outputs[name]
        u_name, pkeys = out.arguments[0], out.arguments[1:]
        return assemble_scalar(out.form, vals[u_name],
                               {k: vals[k] for k in pkeys})
