"""Differentiable implicit PDE solve via the implicit-function theorem.

Port of femo_alpha_tpu/adjoint/implicit.py::ImplicitPDE as a
`torch.autograd.Function`:
  forward:  assemble the operator, set up the preconditioner, solve
  backward: solve A^T lam = g with the SAME operator and preconditioner
            state, then vjp_params = -(dR/dparams)^T lam through the
            assembled residual (`torch.func.vjp`)

BC treatment: the residual is "constrained" (BC rows = u - u_bc); the
linearized solve uses the symmetrically masked operator
B = f*A*f + (1-f)*I, and lam is zeroed at BC dofs.

Facet forms (penalty BCs) add their residual, and their element matrices
enter the operator as one more block. For linear problems the facet
Jacobian depends on the geometry parameters only (uhat), so it is
assembled once per uhat value and reused (`_prepare_facet_ops`).
`extra_residual(u, params)` adds a non-form term to the residual (the
force vector of the force-to-pressure map, the beam's tip load, or a term
in u such as a reaction c*u): it enters the residual and its parameter
gradients, and its linearization at the current u (`torch.func.jvp`)
enters the operator as LinearSolver's `extra_matvec`, for the forward
solve, every Newton step and the adjoint solve, as the reference's
`jax.linearize` does. A term whose linearization is identically zero (a
load) leaves the operator as it is: one jvp probe per linearization
decides (`_extra_linearization`).

Nonlinear problems take `newton_iters` > 1: a fixed-trip Newton loop
(each step linearizes at the current u and solves), then one more
linearization at the RETURNED u, which the adjoint uses — J(u_{N-1})^T
would bias the gradients by O(|u_N - u_{N-1}|).

Preconditioners take part through a split protocol:
    prepare(params, grad_keys) -> aux          (e.g. affine bases)
    setup_state(u, params, ops_Ae, aux) -> state
    apply_state(state, v) -> M^{-1} v
`solve` detaches the parameters before `prepare`; `grad_keys` names those
that required grad (the counterpart of the JAX package's tracer test), so
that a cached basis is not built for a geometry that is being
differentiated: the element-matrix function and the preconditioner then
assemble directly, once per solve. A plain factory
`precond_factory(u, params) -> M` (no `setup_state`) is called at each
linearization instead, as the JAX package's `make_solver` does.

Under parallel/product.py::shard_model (`shard_spec`), the three hooks of
the JAX package split the cell-indexed pieces over the ranks:
`_prepare_aux` (the bases, built on the rank's cells), `_assemble_ops`
(the cell block on the rank's cells, facet blocks replicated) and
`_linearize` (the preconditioner's split state). The residual of the
Newton loop and the parameter vjp of the adjoint are split the same way:
each rank assembles its own cells (the facet and extra terms on rank 0)
and one all_reduce sums them. User pieces without a split hook run whole
on every rank (parallel/product.py::_shard_implicit_pde): a plain factory
is called as it is, a split-protocol preconditioner without `shard_state`
is handed the whole fine block, gathered from the ranks' blocks.
"""

from __future__ import annotations

import hashlib

import torch
from torch.func import vjp

from ..assembly.assemble import FemForm, assemble_residual, element_matrices
from ..assembly.bc import constrain_residual
from ..solvers.linear import LinearSolver


class ImplicitPDE:
    """A linear problem's residual (cell form) with BC data and solver
    options; `solve(params)` is differentiable with respect to every
    parameter tensor that requires grad.

    element_matrices_fn(u, params, basis=...) -> lane-major Ae overrides
    the generic jacfwd assembly of the operator (e.g. the affine design
    decomposition, assembly/affine.py)."""

    def __init__(self, form: FemForm, free_mask, bc_vals, solver_opts=None,
                 element_matrices_fn=None, facet_forms=(),
                 extra_residual=None, newton_iters=1):
        self.form = form
        self.extra_residual = extra_residual
        self.n_dofs = form.space.n_dofs
        self.free_mask = free_mask
        self.bc_vals = bc_vals
        self.newton_iters = newton_iters
        self.solver_opts = dict(solver_opts or {})
        self.element_matrices_fn = element_matrices_fn
        self.facet_forms = [ff for ff in facet_forms if ff.groups]
        # static op layout: the cell block, then one block per facet form
        self._op_specs = [form.space] + [ff.block for ff in self.facet_forms]
        self._fops_cache = None
        pf = self.solver_opts.pop("precond_factory", None)
        # split protocol (prepare/setup_state/apply_state), or a plain
        # factory pf(u, params) -> M
        split = pf is not None and hasattr(pf, "setup_state")
        self._pc = pf if split else None
        self._pf = None if split else pf
        self.last_info = {}
        # parallel/product.py::shard_model: the cell split (None: whole),
        # and which user pieces have no split hook and so run whole
        self.shard_spec = None
        self._emf_whole = self._pc_whole = False

    # -------------------------------------------------- raw pieces
    def residual(self, u, params):
        """Constrained residual: BC rows replaced by (u - u_bc)."""
        r = assemble_residual(self.form, u, params)
        for ff in self.facet_forms:
            r = r + ff.assemble_residual(u, params)
        if self.extra_residual is not None:
            r = r + self.extra_residual(u, params)
        return constrain_residual(r, u, self.free_mask, self.bc_vals)

    def _rank_residual(self, u, params):
        """Under shard_spec: the cell form's residual over this rank's
        cells (not summed over the ranks), plus, on rank 0 only, the facet
        and extra terms: summed over the ranks, the unconstrained
        residual."""
        view = self._op_specs[0]
        rc = self.form.cell_values(self.form.kernel, u, params, chunk=16384,
                                   cells=view.cells)
        r = view.partial_scatter_add(rc)
        if self.shard_spec.rank == 0:
            for ff in self.facet_forms:
                r = r + ff.assemble_residual(u, params)
            if self.extra_residual is not None:
                r = r + self.extra_residual(u, params)
        return r

    def _solve_residual(self, u, params):
        """The constrained residual the Newton loop solves with (no
        autograd): `residual`, or under shard_spec each rank's cells and
        one all_reduce."""
        if self.shard_spec is None:
            return self.residual(u, params)
        r = self.shard_spec.all_reduce(self._rank_residual(u, params))
        return constrain_residual(r, u, self.free_mask, self.bc_vals)

    def _assemble_ops(self, u, params, emf_basis=None, facet_ops=None,
                      direct=False):
        """The element blocks in the `_op_specs` layout, lane-major
        (nd, nd, nc): the cell operator, then the facet blocks (given, or
        assembled here). direct: assemble the cell block directly when no
        basis is given (what `_prepare_aux` asks for when a geometry
        parameter requires grad), instead of preparing one here."""
        fn = self.element_matrices_fn
        spec = self.shard_spec
        if fn is not None and direct and emf_basis is None \
                and hasattr(fn, "direct"):
            ops = [fn.direct(u, params)]
        elif fn is not None:
            ops = [fn(u, params, basis=emf_basis)]
        else:
            cells = (None if spec is None
                     else spec.cells_of(self.form.space).cells)
            Ae = element_matrices(self.form, u, params, cells=cells)
            ops = [Ae.permute(1, 2, 0).contiguous()]
        if facet_ops is None:
            facet_ops = [ff.element_ops(u, params) for ff in self.facet_forms]
        ops = ops + list(facet_ops)
        if spec is not None:
            # parallel/product.py: the cell block on this rank's cells,
            # the facet blocks replicated
            from ..parallel.product import shard_ops

            ops = shard_ops(self, ops)
        return ops

    def _extra_linearization(self, u, params):
        """v -> d extra_residual(u, params)[v] (torch.func.jvp at u), or
        None without an extra residual or when one probe in a fixed
        non-uniform direction gives exactly zero (a load that does not
        depend on u)."""
        if self.extra_residual is None:
            return None
        params = {k: v.detach() for k, v in params.items()}
        u = u.detach()

        def fn(w):
            return self.extra_residual(w, params)

        def lin(v):
            return torch.func.jvp(fn, (u,), (v,))[1]

        probe = torch.linspace(1.0, 2.0, self.n_dofs, dtype=u.dtype,
                               device=u.device)
        if not bool(torch.any(lin(probe) != 0.0)):
            return None
        return lin

    def _solver_from(self, ops_Ae, M_state, u, params):
        M = None
        if self._pf is not None:
            M = M_state
        elif M_state is not None:
            def M(v):
                return self._pc.apply_state(M_state, v)
        return LinearSolver(list(zip(ops_Ae, self._op_specs)), self.n_dofs,
                            free_mask=self.free_mask, M=M,
                            extra_matvec=self._extra_linearization(u, params),
                            **self.solver_opts)

    def _prepare_facet_ops(self, params):
        """The facet blocks, assembled once per value of the parameters the
        facet forms read (content hash; the penalty blocks depend on uhat
        and the geometry only)."""
        if not self.facet_forms:
            return []
        if self.newton_iters != 1:
            return None  # nonlinear: assembled at each linearization
        keys = sorted({k for ff in self.facet_forms for k in ff.param_specs})
        h = hashlib.sha1()
        for k in keys:
            h.update(k.encode())
            h.update(params[k].detach().cpu().numpy().tobytes())
        ck = h.hexdigest()
        if self._fops_cache is None or self._fops_cache[0] != ck:
            u0 = torch.zeros(self.n_dofs, dtype=self.free_mask.dtype,
                             device=self.free_mask.device)
            fops = [ff.element_ops(u0, params) for ff in self.facet_forms]
            self._fops_cache = (ck, fops)
        return self._fops_cache[1]

    def _prepare_aux(self, params, grad_keys=frozenset()):
        """(cell basis, preconditioner aux, facet blocks) for detached
        params; grad_keys: the parameters that require grad. A basis of
        None means a direct assembly of the cell block."""
        fn = self.element_matrices_fn
        emb = (fn.prepare(params, grad_keys) if hasattr(fn, "prepare")
               else None)
        pca = (self._pc.prepare(params, grad_keys) if self._pc is not None
               else ())
        aux = emb, pca, self._prepare_facet_ops(params)
        if self.shard_spec is not None:
            # parallel/product.py: every cell-indexed basis on this rank's
            # cells (built there by the split assemblers)
            from ..parallel.product import shard_aux

            aux = shard_aux(self, aux)
        return aux

    def _linearize(self, u, params, aux):
        """The operator blocks and preconditioner state at u."""
        emf_basis, pc_aux, facet_ops = aux
        ops_Ae = self._assemble_ops(u, params, emf_basis=emf_basis,
                                    facet_ops=facet_ops, direct=True)
        spec = self.shard_spec
        if self._pf is not None:
            # under shard_model: split by its shard_state, or called whole
            # on every rank with the replicated (u, params)
            M_state = self._pf(u, params)
        elif self._pc is not None:
            # under shard_model a split-protocol preconditioner was split
            # once (its shard_state): its state is built on this rank's
            # cells of every level, reduced where it is global. One
            # without shard_state gets the whole fine block, gathered
            pc_ops = ops_Ae
            if spec is not None and self._pc_whole:
                pc_ops = [spec.gather_cells(ops_Ae[0], self._op_specs[0])] \
                    + list(ops_Ae[1:])
            M_state = self._pc.setup_state(u, params, pc_ops, pc_aux)
        else:
            M_state = None
        return ops_Ae, M_state

    def _newton_state(self, params, u0, aux):
        """newton_iters Newton steps from u0 (one is exact for a linear
        problem): returns (u, linearization state) — the state is what
        the adjoint reuses, re-linearized at the returned u when the
        problem is nonlinear. last_info["forward"] is the last step's
        solve; "newton" lists every step's."""
        f = self.free_mask
        u = f * u0 + (1.0 - f) * self.bc_vals
        infos = []
        for _ in range(self.newton_iters):
            r = self._solve_residual(u, params)
            ops_Ae, M_state = self._linearize(u, params, aux)
            solver = self._solver_from(ops_Ae, M_state, u, params)
            u = u - solver.solve(r)
            infos.append(solver.last_info)
        self.last_info["forward"] = infos[-1]
        if self.newton_iters > 1:
            self.last_info["newton"] = infos
            ops_Ae, M_state = self._linearize(u, params, aux)
        return u, (ops_Ae, M_state)

    def make_solver(self, u, params) -> LinearSolver:
        """The LinearSolver of the system linearized at u (the operator
        blocks and the preconditioner the solve path would use), for
        callers that drive their own solves: the csdl operations and the
        modal path."""
        with torch.no_grad():
            p = {k: v.detach() for k, v in params.items()}
            return self._solver_from(
                *self._linearize(u, p, self._prepare_aux(p)), u, p)

    def _bwd_impl(self, params, u, ops_Ae, M_state, g, wrt):
        """-(dR/dp)^T lam for the parameters named in `wrt`."""
        solver = self._solver_from(ops_Ae, M_state, u, params)
        lam = self.free_mask * solver.solve_transpose(self.free_mask * g)
        self.last_info["adjoint"] = solver.last_info
        if not wrt:
            return {}
        fixed = {k: v for k, v in params.items() if k not in wrt}
        spec = self.shard_spec
        if spec is None:
            def res(*vals):
                return self.residual(u, {**fixed, **dict(zip(wrt, vals))})
        else:
            # this rank's cells (and, on rank 0, the facet and extra
            # terms); the BC rows' (u - u_bc) holds no parameter
            def res(*vals):
                return self.free_mask * self._rank_residual(
                    u, {**fixed, **dict(zip(wrt, vals))})

        _, vjp_fn = vjp(res, *[params[k] for k in wrt])
        grads = vjp_fn(lam)
        if spec is not None:
            # one all_reduce of every gradient: a DG0 field's entries come
            # from one rank each (exact), the others are partial sums
            flat = spec.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
            grads = [g.reshape(params[k].shape) for g, k in zip(
                torch.split(flat, [g.numel() for g in grads]), wrt)]
        return {k: -gk for k, gk in zip(wrt, grads)}

    # -------------------------------------------------- public API
    def solve(self, params, u0=None):
        """Differentiable solve; params: dict of parameter tensors."""
        if u0 is None:
            u0 = torch.zeros_like(self.free_mask)
        keys = tuple(params)
        grad_keys = frozenset(
            k for k, v in params.items()
            if v.requires_grad and torch.is_grad_enabled())
        with torch.no_grad():
            aux = self._prepare_aux({k: v.detach() for k, v in
                                     params.items()}, grad_keys)
        return _ImplicitSolve.apply(self, aux, keys, u0.detach(),
                                    *[params[k] for k in keys])


class _ImplicitSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pde, aux, keys, u0, *vals):
        params = dict(zip(keys, vals))
        u, state = pde._newton_state(params, u0, aux)
        ctx.pde, ctx.keys, ctx.state = pde, keys, state
        ctx.save_for_backward(u, *vals)
        return u

    @staticmethod
    def backward(ctx, g):
        u, *vals = ctx.saved_tensors
        params = dict(zip(ctx.keys, vals))
        need = ctx.needs_input_grad[4:]
        wrt = [k for k, n in zip(ctx.keys, need) if n]
        with torch.no_grad():
            gp = ctx.pde._bwd_impl(params, u, *ctx.state, g, wrt)
        return (None, None, None, None,
                *[gp.get(k) for k in ctx.keys])
