"""FEAModel: run all states + outputs of one or more FEA problems as one
differentiable function (port of femo_alpha_tpu/fea/model.py).

`evaluate(inputs) -> VariableGroup`: every state is an implicit solve,
every output and field output is evaluated on first access. The group holds
tensors; call `.backward()` on any output.
"""

from __future__ import annotations

from types import SimpleNamespace


class VariableGroup(SimpleNamespace):
    """Attribute bag of tensors. Entries may be lazy (computed on first
    attribute access and cached), see `add_lazy`."""

    def add_lazy(self, name, thunk):
        self.__dict__.setdefault("_lazy", {})[name] = thunk

    def __getattr__(self, name):
        lazy = self.__dict__.get("_lazy")
        if lazy and name in lazy:
            val = lazy.pop(name)()
            setattr(self, name, val)
            return val
        raise AttributeError(name)

    def to_dict(self):
        """Every entry as a dict, still-lazy ones computed first."""
        for name in list(self.__dict__.get("_lazy", {})):
            getattr(self, name)
        return {k: v for k, v in self.__dict__.items() if k != "_lazy"}


class FEAModel:
    def __init__(self, fea, warm_start=True):
        """fea: list of FEA problems (evaluated in order, states chained).

        warm_start: start each solve from the previous evaluation's
        solution (detached) as the Newton initial guess."""
        self.fea_list = fea if isinstance(fea, (list, tuple)) else [fea]
        self.warm_start = warm_start
        self._last_states: dict = {}

    def evaluate(self, inputs) -> VariableGroup:
        """inputs: dict or VariableGroup of input tensors keyed by input
        name. Returns a VariableGroup with inputs, states, outputs and
        field outputs."""
        vals = dict(inputs.to_dict() if hasattr(inputs, "to_dict")
                    else inputs)
        out = VariableGroup()
        for fea in self.fea_list:
            for sname, st in fea.states.items():
                params = {k: vals[k] for k in st.arguments}
                u0 = self._last_states.get(sname) if self.warm_start \
                    else None
                u = fea.solve(sname, params, u0=u0)
                vals[sname] = u
                self._last_states[sname] = u.detach()
            for oname in fea.outputs:
                out.add_lazy(oname, lambda fea=fea, oname=oname, vals=vals:
                             fea.evaluate_output(oname, vals))
            for fname in fea.field_outputs:
                out.add_lazy(fname, lambda fea=fea, fname=fname, vals=vals:
                             fea.evaluate_field_output(fname, vals))
        for k, v in vals.items():
            setattr(out, k, v)
        return out
