"""Gradient-based optimization (port of femo_alpha_tpu/opt/problem.py).

The same scipy SLSQP loop: the design vector lives on the host as f64
numpy for scipy, and each evaluation hands the model f64 tensors on the
problem's device (the CUDA card unless `device` names another). The
objective's gradient is one `torch.autograd.grad` through the model; a
vector-valued constraint's Jacobian is one backward per component
(`retain_graph`), which for an implicit solve is one adjoint solve per
component, as `jax.jacrev` is in the JAX package.

scipy asks for the objective, each constraint's value and each
constraint's Jacobian in separate calls at the same x. The JAX package
re-runs forward + adjoint for each of them; here the model is evaluated
once per design point (memoized on x's bytes), and from that evaluation
each output's value is read once and its gradient computed once, only
when scipy asks for it. That changes no number of the SLSQP trajectory
beyond the solves' own tolerance.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from scipy.optimize import minimize

from ..device import resolve_device
from ..utils.logging import log


class OptimizationProblem:
    """evaluate: dict(design tensors) -> dict-like with scalar (or vector)
    outputs, differentiable in the design tensors."""

    def __init__(self, evaluate, jit=True, precompute=(), device=None):
        """jit: accepted for API parity with the JAX package; it has no
        effect in eager torch. precompute: callables(dvs dict) run at each
        new design point before the model is evaluated there (e.g. a warm
        call of RMShellModel.modal_eigenvalues, whose eigensolve is
        memoized per design point). device: where the design tensors live;
        None means the CUDA card (raises without one)."""
        self._evaluate = evaluate
        self.jit = jit
        self.precompute = list(precompute)
        self.device = resolve_device(device)
        self._last_precompute_x = None
        self.dvs: dict[str, dict] = {}
        self.objective = None
        self.obj_scaler = 1.0
        self.constraints: list[dict] = []
        self.result = None
        self._point = None      # (x bytes, x tensor, outputs, {name: ...})
        self._fvals = {}        # x bytes -> scaled objective value
        self.history = []       # scaled objective at each SLSQP iterate
        self.counts = {"evaluate": 0, "backward": 0}
        self.model_seconds = 0.0

    def _run_precompute(self, x):
        if not self.precompute:
            return
        key = np.asarray(x, dtype=np.float64).tobytes()
        if key == self._last_precompute_x:
            return
        self._last_precompute_x = key
        with torch.no_grad():
            dvs = self._unpack(np.asarray(x, dtype=np.float64))
        for fn in self.precompute:
            fn(dvs)

    def add_design_variable(self, name, init, lower=None, upper=None):
        """lower/upper: scalar or array broadcastable to init's shape."""
        init = np.atleast_1d(np.asarray(init, dtype=np.float64))
        self.dvs[name] = dict(init=init, lower=lower, upper=upper,
                              size=init.size, shape=init.shape)

    def set_objective(self, name, scaler=1.0):
        self.objective = name
        self.obj_scaler = scaler

    def add_constraint(self, name, lower=None, upper=None, equals=None,
                       scaler=1.0):
        """scaler multiplies the constraint value and its bounds before
        they reach SLSQP."""
        self.constraints.append(
            dict(name=name, lower=lower, upper=upper, equals=equals,
                 scaler=scaler))

    # ------------------------------------------------------------ plumbing
    def _pack(self, dv_dict):
        return np.concatenate(
            [np.asarray(dv_dict[k], dtype=np.float64).ravel()
             for k in self.dvs])

    def _unpack(self, x):
        """x (numpy or a flat tensor) -> {name: f64 tensor on the device}."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x, dtype=np.float64),
                                device=self.device)
        out, o = {}, 0
        for k, spec in self.dvs.items():
            out[k] = x[o: o + spec["size"]].reshape(spec["shape"])
            o += spec["size"]
        return out

    @staticmethod
    def _output(outs, name):
        if hasattr(outs, "to_dict"):
            outs = outs.to_dict()
        if isinstance(outs, dict):
            return outs[name]
        return getattr(outs, name)

    def _at(self, x):
        """The model evaluated at x (memoized on the last design point)."""
        x = np.asarray(x, dtype=np.float64)
        key = x.tobytes()
        if self._point is None or self._point[0] != key:
            self._point = None  # free the previous point's graph first
            self._run_precompute(x)
            t = time.perf_counter()
            xt = torch.tensor(x, dtype=torch.float64, device=self.device,
                              requires_grad=True)
            outs = self._evaluate(self._unpack(xt))
            self.model_seconds += time.perf_counter() - t
            self.counts["evaluate"] += 1
            self._point = (key, xt, outs, {})
        return self._point

    def _output_at(self, x, name):
        """The cache entry of output `name` at x: {"y": flat tensor, and
        "v" / "J" once computed}."""
        _, _, outs, cache = self._at(x)
        if name not in cache:
            y = self._output(outs, name)
            if not isinstance(y, torch.Tensor):
                y = torch.as_tensor(y, dtype=torch.float64,
                                    device=self.device)
            cache[name] = {"y": y.reshape(-1)}
        return cache[name]

    def _value(self, x, name, scaler):
        """Output `name` times `scaler` at x, (m,) f64 numpy."""
        c = self._output_at(x, name)
        if "v" not in c:
            t = time.perf_counter()
            c["v"] = c["y"].detach().cpu().numpy().astype(np.float64)
            self.model_seconds += time.perf_counter() - t
        return scaler * c["v"]

    def _jac(self, x, name, scaler):
        """Its Jacobian times `scaler` at x, (m, n) f64 numpy: one
        backward per component."""
        c = self._output_at(x, name)
        if "J" not in c:
            t = time.perf_counter()
            xt, y = self._point[1], c["y"]
            rows = []
            for i in range(y.numel()):
                g = None
                if y.requires_grad:
                    (g,) = torch.autograd.grad(y[i], xt, retain_graph=True,
                                               allow_unused=True)
                    self.counts["backward"] += 1
                rows.append(torch.zeros_like(xt) if g is None else g)
            c["J"] = torch.stack(rows).cpu().numpy().astype(np.float64)
            self.model_seconds += time.perf_counter() - t
        return scaler * c["J"]

    # ------------------------------------------------------------- solve
    def solve(self, maxiter=1000, ftol=1e-9, callback=None, report=True):
        assert self.objective is not None, "set_objective first"
        x0 = self._pack({k: v["init"] for k, v in self.dvs.items()})
        self.history = []

        def obj(x):
            f = float(self._value(x, self.objective, self.obj_scaler)[0])
            self._fvals[np.asarray(x, dtype=np.float64).tobytes()] = f
            return f, self._jac(x, self.objective, self.obj_scaler)[0]

        cons = []
        for c in self.constraints:
            name, sc = c["name"], c.get("scaler", 1.0)

            def make(name, sc, shift, sign):
                # scipy SLSQP accepts vector-valued constraint functions:
                # fun -> (m,), jac -> (m, n); scalars are m = 1
                def fun(x):
                    return sign * (self._value(x, name, sc) - shift)

                def jac(x):
                    return sign * self._jac(x, name, sc)

                return fun, jac

            if c["equals"] is not None:
                fun, jac = make(name, sc, sc * np.asarray(
                    c["equals"], dtype=np.float64), 1.0)
                cons.append(dict(type="eq", fun=fun, jac=jac))
            else:
                if c["lower"] is not None:
                    fun, jac = make(name, sc, sc * np.asarray(
                        c["lower"], dtype=np.float64), 1.0)
                    cons.append(dict(type="ineq", fun=fun, jac=jac))
                if c["upper"] is not None:
                    fun, jac = make(name, sc, sc * np.asarray(
                        c["upper"], dtype=np.float64), -1.0)
                    cons.append(dict(type="ineq", fun=fun, jac=jac))

        bounds = None
        lo_up = []
        for k, spec in self.dvs.items():
            lo, up = spec["lower"], spec["upper"]
            if lo is None and up is None:
                lo_up += [(None, None)] * spec["size"]
                continue

            def _arr(v, spec=spec):
                if v is None:
                    return [None] * spec["size"]
                return list(np.broadcast_to(
                    np.asarray(v, dtype=np.float64), spec["shape"]).ravel())

            lo_up += list(zip(_arr(lo), _arr(up)))
        if any(lo is not None or up is not None for lo, up in lo_up):
            bounds = lo_up

        def on_iter(xk):
            key = np.asarray(xk, dtype=np.float64).tobytes()
            f = self._fvals.get(key)
            self.history.append(f if f is not None else obj(xk)[0])
            if callback is not None:
                callback(xk)

        res = minimize(obj, x0, jac=True, method="SLSQP", bounds=bounds,
                       constraints=cons, callback=on_iter,
                       options={"maxiter": maxiter, "ftol": ftol})
        self.result = res
        self._point = None
        self._fvals = {}
        if report:
            log(f"SLSQP: {res.message} | f*={res.fun:.10g} | nit={res.nit} "
                f"| nfev={res.nfev} | njev={res.njev}")
        with torch.no_grad():
            return self._unpack(res.x), res


class SLSQP:
    """Name-parity shim for the reference's `SLSQP(prob, ...)` interface."""

    def __init__(self, problem: OptimizationProblem, solver_options=None):
        self.problem = problem
        self.options = dict(solver_options or {})

    def solve(self):
        maxiter = self.options.get("maxiter", 1000)
        ftol = self.options.get("ftol", 1e-9)
        return self.problem.solve(maxiter=maxiter, ftol=ftol)

    def print_results(self):
        res = self.problem.result
        if res is not None:
            log(f"objective={res.fun:.12g} iterations={res.nit} "
                f"success={res.success}")
