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


class FEAModel:
    def __init__(self, fea):
        """fea: list of FEA problems (evaluated in order, states chained).
        Each solve starts from the previous evaluation's solution."""
        self.fea_list = fea if isinstance(fea, (list, tuple)) else [fea]
        self._last_states: dict = {}

    def evaluate(self, inputs) -> VariableGroup:
        vals = dict(inputs)
        out = VariableGroup()
        for fea in self.fea_list:
            for sname, st in fea.states.items():
                params = {k: vals[k] for k in st.arguments}
                u = fea.solve(sname, params,
                              u0=self._last_states.get(sname))
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
