"""StateOperation: the reference's implicit-operation contract over the
port's ImplicitPDE (port of femo_alpha_tpu/csdl_opt/state_operation.py).

  evaluate                 -> the solved state
  solve_residual_equations -> the forward solve
  compute_jacvec_product   -> 'fwd': dR/dp . dp by torch.func.jvp of the
                              assembled residual; 'rev': dR/dp^T lam by
                              torch.func.vjp
  apply_inverse_jacobian   -> 'fwd': A du = dR; 'rev': A^T lam = du with the
                              BC rows zeroed (LinearSolver.solve /
                              solve_transpose)
"""

from __future__ import annotations

import torch
from torch.func import jvp, vjp

from ..device import tensor_on


class StateOperation:
    def __init__(self, fea, state_name, record=False):
        self.fea = fea
        self.state_name = state_name
        self.record = record
        self._pde = fea._get_pde(state_name)
        self._last = None  # (u, params, solver)

    def _tensor(self, v):
        return tensor_on(v, self.fea.device, "StateOperation", self.fea.dtype)

    # ------------------------------------------------------------- contract
    def evaluate(self, inputs: dict):
        return self.solve_residual_equations(inputs)

    def solve_residual_equations(self, inputs: dict):
        st = self.fea.states[self.state_name]
        params = {k: self._tensor(inputs[k]).detach() for k in st.arguments}
        with torch.no_grad():
            u = self._pde.solve(params)
        self._last = (u, params, None)
        return u

    def _solver(self):
        u, params, solver = self._last
        if solver is None:
            solver = self._pde.make_solver(u, params)
            self._last = (u, params, solver)
        return solver

    def compute_jacvec_product(self, inputs: dict, mode: str, vec):
        """'fwd': vec is a dict of parameter tangents -> dR (n_dofs,).
        'rev': vec is lam (n_dofs,) -> dict of parameter cotangents."""
        u, params, _ = self._last
        keys = list(params)

        def r_of_p(*vals):
            return self._pde.residual(u, dict(zip(keys, vals)))

        vals = tuple(params[k] for k in keys)
        if mode == "fwd":
            tangents = tuple(self._tensor(vec[k]) for k in keys)
            _, dr = jvp(r_of_p, vals, tangents)
            return dr
        _, vjp_fn = vjp(r_of_p, *vals)
        gs = vjp_fn(self._pde.free_mask * self._tensor(vec))
        return dict(zip(keys, gs))

    def apply_inverse_jacobian(self, d_residual, mode: str):
        """'fwd': solve A du = d_residual; 'rev': solve A^T lam = d_state,
        zeroing lam at the BC dofs."""
        solver = self._solver()
        f = self._pde.free_mask
        d = f * self._tensor(d_residual)
        if mode == "fwd":
            return solver.solve(d)
        return f * solver.solve_transpose(d)
