"""FEA: problem registry + solve facade.

Port of femo_alpha_tpu/fea/fea.py: add_input / add_state (linear or
Newton, facet forms, a state-independent extra residual, solver options) /
add_strong_bc / add_output (a form or a function) / add_field_output,
solve, the tangent and adjoint solves solveLinearFwd / solveLinearBwd,
add_exact_solution / compute_error, evaluate_output and
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
    init_val: object = None
    record: bool = False


@dataclass
class _State:
    form: FemForm
    arguments: list
    extra_residual: Optional[Callable] = None
    newton_iters: int = 1
    solver_opts: dict = field(default_factory=dict)
    facet_forms: tuple = ()
    element_matrices_fn: Optional[Callable] = None
    pde: Optional[ImplicitPDE] = None


@dataclass
class _Output:
    fn: Optional[Callable]  # fn(vals) -> value, or None for a form
    arguments: list
    form: Optional[FemForm] = None
    record: bool = False


class FEA:
    """Registry of inputs / states / outputs over one mesh. `dtype` and
    `device` are those of the BC masks and of every solve; device None
    means the CUDA card. linear_problem: add_state's newton_iters
    defaults to 1 when True, else 3."""

    def __init__(self, mesh, dtype=torch.float64, device=None):
        self.mesh = mesh
        self.dtype = dtype
        self.device = resolve_device(device)
        self.inputs: dict[str, _Input] = {}
        self.states: dict[str, _State] = {}
        self.outputs: dict[str, _Output] = {}
        self.field_outputs: dict[str, _Output] = {}
        self.bcs: list[DirichletBC] = []
        self.exact_solutions: dict[str, Callable] = {}
        self.linear_problem = True

    def add_input(self, name, space, init_val=None, record=False):
        self.inputs[name] = _Input(space, init_val, record)

    def add_state(self, name, residual_form: FemForm, arguments,
                  extra_residual=None, newton_iters=None, solver_opts=None,
                  facet_forms=(), element_matrices_fn=None):
        """A state: residual_form over the state space (plus facet forms,
        e.g. penalty BCs, and extra_residual(u, params), a non-form term
        such as a load or a reaction c*u, whose linearization in u enters
        the operator); arguments: the input names the residual reads;
        newton_iters: fixed Newton steps (1 for a linear problem)."""
        ni = newton_iters if newton_iters is not None else (
            1 if self.linear_problem else 3)
        self.states[name] = _State(residual_form, list(arguments),
                                   extra_residual, ni,
                                   dict(solver_opts or {}),
                                   tuple(facet_forms), element_matrices_fn)
        self._build_pde(name)

    def add_output(self, name, form=None, arguments=(), fn=None):
        """Scalar output: either an energy-kind FemForm whose first argument
        is the field it integrates, or fn(vals) -> scalar."""
        if (form is None) == (fn is None):
            raise ValueError("add_output: give exactly one of form and fn")
        self.outputs[name] = _Output(fn, list(arguments), form)

    def add_field_output(self, name, fn, arguments=(), record=False):
        """Field output: fn(vals) -> tensor (e.g. an L2 projection)."""
        self.field_outputs[name] = _Output(fn, list(arguments), None, record)

    def add_strong_bc(self, dofs, values=0.0):
        self.bcs.append(DirichletBC(dofs, values))
        for name in self.states:
            self._build_pde(name)

    def _build_pde(self, name):
        st = self.states[name]
        free, bcv = combine_bcs(st.form.space.n_dofs, self.bcs,
                                dtype=self.dtype, device=self.device)
        opts = {"method": "cg", "tol": 1e-12}
        opts.update(st.solver_opts)
        st.pde = ImplicitPDE(st.form, free, bcv, solver_opts=opts,
                             element_matrices_fn=st.element_matrices_fn,
                             facet_forms=st.facet_forms,
                             extra_residual=st.extra_residual,
                             newton_iters=st.newton_iters)

    def _get_pde(self, name) -> ImplicitPDE:
        return self.states[name].pde

    def solve(self, name, params, u0=None):
        """Differentiable solve of one state."""
        return self.states[name].pde.solve(params, u0=u0)

    def solveLinearFwd(self, name, u, params, dR):
        """Tangent solve (dR/du) du = dR at the linearization point u, with
        the state's operator and preconditioner."""
        pde = self._get_pde(name)
        return pde.make_solver(u, params).solve(pde.free_mask * dR)

    def solveLinearBwd(self, name, u, params, g):
        """Adjoint solve (dR/du)^T lam = g, with the BC rows of lam
        zeroed."""
        pde = self._get_pde(name)
        lam = pde.make_solver(u, params).solve_transpose(pde.free_mask * g)
        return pde.free_mask * lam

    def add_exact_solution(self, name, fn):
        """Register an exact solution for a state: fn maps physical points
        (n, gdim) -> values, evaluated at quadrature points by
        `compute_error`."""
        self.exact_solutions[name] = fn

    def compute_error(self, name, u, norm="L2"):
        """Error norm of a state against its registered exact solution (a
        float)."""
        from .utils import errorNorm

        space = self.states[name].form.space
        return errorNorm(space, u, self.exact_solutions[name], norm=norm,
                         device=self.device)

    def evaluate_output(self, name, vals):
        out = self.outputs[name]
        if out.form is None:
            sub = ({k: vals[k] for k in out.arguments} if out.arguments
                   else dict(vals))
            return out.fn(sub)
        u_name, pkeys = out.arguments[0], out.arguments[1:]
        return assemble_scalar(out.form, vals[u_name],
                               {k: vals[k] for k in pkeys})

    def evaluate_field_output(self, name, vals):
        out = self.field_outputs[name]
        sub = ({k: vals[k] for k in out.arguments} if out.arguments
               else dict(vals))
        return out.fn(sub)
