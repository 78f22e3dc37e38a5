"""PlateSim: the transient Reissner-Mindlin shell, implicit midpoint in
time.

Port of femo_alpha_tpu/models/dynamic_rm_shell/plate_sim.py. The scheme

    wdot_i  = (2/dt)(w_i - w_{i-1}) - wdot_{i-1}
    wddot_i = (wdot_i - wdot_{i-1}) / dt
    M wddot_i + K (w_i + w_{i-1})/2 - F_i = 0

has one step operator A = (2/dt^2) M + K/2 per design, so the simulation
is a loop of linear solves A_c w_i = b_i with
b_i = free * (F_i + (2/dt^2) M w + (2/dt) M wdot - K w / 2) and
A_c = free*A*free + (1 - free)*I.

On the card: with element-wise thickness, K = h K1 + h^3 K3 and M = h M1
exactly, so K, M and A are affine bases (A's built basis by basis from K's
and M's once per dt), each combined by K2 once per design. With nodal
(CG1) thickness, the default, K and M are not affine per cell: they are
assembled directly (torch.func) once per design, as the reference's
`_element_mats` does. Every K and M product is one fused-operator pass
with free = ones (assembly/affine.py AffineApply, whose design gradient is
the closed-form vjp_theta, or `_ElementApply` on directly assembled
matrices), and every step solve is `_StepSolve`, an autograd Function
over the configured solver — a dense Cholesky, Jacobi-PCG, or PCG
preconditioned by a geometric-MG V-cycle (dynamic_rm_shell/mg.py) whose
state is made once per simulate and reused by every step and by the
adjoint. Autograd over the eager time loop then is the time-reversed
adjoint sweep that `lax.scan`'s AD gives the JAX package;
`simulate_outputs` checkpoints segments of the loop
(torch.utils.checkpoint), so reverse-mode memory is O(sqrt(N_t) n). On
the nodal path each product and step solve returns the per-cell
cotangent of its element matrices, -(f lam)_c (f w)_c^T for a solve;
autograd sums them over the steps and takes them through the direct
assembly once (the vjp of the element assembly in the thickness).

Under parallel/product.py::shard_model (`shard_spec`) each rank holds
its own cells of K's, M's and A's bases (or of the directly assembled
element matrices) and of every step-MG level: every K, M and step-operator
product and every V-cycle pass runs the fused operator over the rank's
cells, then one all_reduce; the design gradient through them comes back
on the rank's cells and is summed over the ranks once per backward
(parallel.grad_all_reduce). Loads, energies and outputs stay replicated.
The JAX package's fixed-trip inner CG, a TPU workaround, is not ported:
`inner_iters` caps PCG's iterations at the same target instead. The
simulator runs on the CUDA card unless `device` names another; without a
card and without `device` it raises (pass device="cpu" for the CPU).
"""

from __future__ import annotations

import os
import time
import warnings

import numpy as np
import torch
from torch.func import jacfwd
from torch.utils.checkpoint import checkpoint

from ...assembly.affine import (
    AffineOperator,
    CachedAffineAssembler,
    _affine_combine,
    _cut,
    _padded,
    _vjp_theta,
)
from ...assembly.assemble import (
    FemForm,
    assemble_residual,
    assemble_scalar,
    element_matrices,
    make_constrained_matvec_T,
)
from ...assembly.bc import DirichletBC, combine_bcs
from ...device import resolve_device, tensor_on
from ...solvers.krylov import cg_solve
from ...solvers.linear import LinearSolver
from ...solvers.precond import jacobi_preconditioner
from ...spaces.pointeval import point_eval_rows
from ..rm_shell.kinematics import surface_geometry
from ..rm_shell.mg import _cycle_in, strong_bc_dofs
from ..rm_shell.pde import RMShellPDE, _interp_vec


def _default_bc(x):
    return np.abs(x[:, 0]) < 1e-6  # clamp x = 0 (the reference's default)


class _ElementOperator:
    """x -> A x for directly assembled lane-major element matrices Ae
    (nd, nd, nc) that may carry an autograd graph to the design: one
    fused-operator pass with free = ones; calls are differentiable in Ae
    and x through _ElementApply."""

    def __init__(self, Ae, space):
        self.Ae, self.space = Ae, space
        ones = torch.ones(space.n_dofs, dtype=Ae.dtype, device=Ae.device)
        self.matvec = make_constrained_matvec_T(Ae.detach(), space, ones)

    def __call__(self, x):
        return _ElementApply.apply(self.Ae, x, self)


def _cell_outer(space, a, b):
    """The lane-major per-cell outer products a_c b_c^T (nd, nd, nc)."""
    acT = space.gather_T(a)
    bcT = space.gather_T(b)
    return acT[:, None, :] * bcT[None, :, :]


class _ElementApply(torch.autograd.Function):
    """y = A x on element matrices Ae. A is symmetric, so dx = A g (one
    more fused-operator pass); dAe is the per-cell outer product
    g_c x_c^T."""

    @staticmethod
    def forward(ctx, Ae, x, op):
        ctx.op = op
        ctx.save_for_backward(x)
        return op.matvec(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        op = ctx.op
        g = g.contiguous()
        dAe = dx = None
        if ctx.needs_input_grad[0]:
            dAe = _cell_outer(op.space, g, x)
        if ctx.needs_input_grad[1]:
            dx = op.matvec(g)
        return dAe, dx, None


class _StepOperators:
    """One design's operators: the K and M products, the constrained step
    operator A_c and its solver (state made once here, reused by every
    step and by the adjoint). `design` is what a step solve differentiates
    into: theta on the affine path, the step operator's element matrices
    (with their graph to theta) on the nodal path. `log` collects (phase,
    CG iterations) of every solve."""

    def __init__(self, sim, theta):
        # the space, or this rank's cells of it under a split (the design
        # then enters through grad_all_reduce: the split products give
        # the rank's cells of its gradient)
        W, free = sim._op_space(), sim.free_mask
        theta = sim._split_design(theta)
        self.free, self.space, self.nc = free, W, sim.nel
        if sim.element_wise_thickness:
            BK, BM, BA = sim._bases(theta)
            self.BA = BA
            self.K = AffineOperator(BK, (1, 3), theta, W)
            self.M = AffineOperator(BM, (1,), theta, W)
            with torch.no_grad():
                Ae = _affine_combine(
                    BA, _cut(theta.detach(), getattr(W, "cells", None)),
                    (1, 3))
            self.design = theta
        else:
            Ke, Me = sim._element_mats(theta)
            self.K = _ElementOperator(Ke, W)
            self.M = _ElementOperator(Me, W)
            self.design = (2.0 / sim.dt ** 2) * Me + 0.5 * Ke
            Ae = self.design.detach()
        self.Ae = Ae
        self.A_c = make_constrained_matvec_T(Ae, W, free)
        self.log = []
        self.method = sim.solver_method
        if self.method == "dense":
            self._dense = LinearSolver([(Ae, W)], W.n_dofs, free,
                                       method="dense")
            return
        if self.method == "mg":
            # the hierarchy's own precision (build_platesim_mg(dtype=)):
            # an f32 state takes the vector cast to f32 and back
            state = sim.mg.setup({"thickness": theta.detach()}, Ae0=Ae,
                                 dtype=getattr(sim.mg, "dtype", None))

            def Minv(v):
                return _cycle_in(sim.mg, state, v)
        else:
            # Jacobi: the constrained operator's diagonal
            with torch.no_grad():
                Minv = jacobi_preconditioner(Ae, W, W.n_dofs, free)
        self.Minv = Minv
        n = W.n_dofs
        self.maxiter = (int(sim.inner_iters) if sim.inner_iters is not None
                        else 100 * int(n ** 0.5))

    def solve(self, b, phase):
        """A_c^{-1} b: tol 1e-11 relative to ||b||."""
        if self.method == "dense":
            self.log.append((phase, 0))
            return self._dense.solve(b)
        x, info = cg_solve(self.A_c, b, M=self.Minv, tol=1e-11,
                           maxiter=self.maxiter)
        self.log.append((phase, info["iters"]))
        return x

    def design_grad(self, design, w, lam):
        """-(lam^T dA/d design w) at the solve's free*w and free*lam: the
        closed-form vjp_theta on A's basis (affine), or the per-cell outer
        product -(f lam)_c (f w)_c^T (nodal element matrices)."""
        f = self.free
        if design.dim() == 1:
            return -_padded(_vjp_theta(self.BA, (1, 3), design, f * w,
                                       f * lam, self.space),
                            self.space, self.nc)
        return -_cell_outer(self.space, f * lam, f * w)

    def residual(self, b, w):
        """||b - A_c w|| / ||b||: solver telemetry, not differentiated."""
        with torch.no_grad():
            bn = torch.linalg.norm(b)
            return torch.linalg.norm(b - self.A_c(w.contiguous())) / \
                torch.clamp(bn, min=1e-300)


class _StepSolve(torch.autograd.Function):
    """w = A_c(design)^{-1} b. Backward: lam = A_c^{-1} g with the same
    solver and state (A_c is symmetric); d b = lam and
    d design = ops.design_grad(design, w, lam) — what custom_linear_solve
    differentiates in the JAX package."""

    @staticmethod
    def forward(ctx, b, design, ops):
        w = ops.solve(b.contiguous(), "forward")
        ctx.ops = ops
        ctx.save_for_backward(design, w)
        return w

    @staticmethod
    def backward(ctx, g):
        design, w = ctx.saved_tensors
        ops = ctx.ops
        lam = ops.solve(g.contiguous(), "adjoint")
        dd = None
        if ctx.needs_input_grad[1]:
            dd = ops.design_grad(design, w, lam)
        return lam, dd, None


class PlateSim:
    def __init__(self, mesh, E, nu, rho, dt, Nsteps,
                 element_wise_thickness=False, custom_bc_func=None,
                 add_self_weight=False, g_factor=None, quad_deg=3,
                 solver_method=None, inner_iters=None, mg_coarsest_cells=64,
                 device=None):
        if solver_method not in (None, "mg", "cg", "dense"):
            raise ValueError(f"PlateSim: solver_method={solver_method!r} "
                             "(None, 'mg', 'cg' or 'dense')")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.E, self.nu, self.rho = E, nu, rho
        self.dt, self.Nsteps = dt, Nsteps
        self.time_levels = Nsteps + 1
        self.nn, self.nel = mesh.n_nodes, mesh.n_cells
        self.quad_deg = quad_deg
        self.element_wise_thickness = element_wise_thickness
        self.add_self_weight = add_self_weight
        self.g_factor = g_factor

        pde = self.pde = RMShellPDE(
            mesh, element_wise_material=element_wise_thickness,
            inplane_deg=quad_deg,
            shear_deg=quad_deg, stress_deg=quad_deg, device=self.device)
        self.W, self.W_t, self.W_f = pde.W, pde.VT, pde.VF
        self.fe_dofs = self.W.n_dofs
        self.num_var = self.W_t.n_dofs
        self.bc_func = custom_bc_func or _default_bc
        t64 = dict(dtype=torch.float64, device=self.device)
        self.free_mask, self.bc_vals = combine_bcs(
            self.fe_dofs, [DirichletBC(strong_bc_dofs(pde, self.bc_func))],
            **t64)

        # linear forms: the element matrices depend on the thickness only
        self.K_form = pde.elastic_energy_form()
        self.M_form = pde.inertia_form(rho_is_param=False)
        self._zero_w = torch.zeros(self.fe_dofs, **t64)
        self._zero_uhat = torch.zeros(pde.VU.n_dofs, **t64)
        nT = self.num_var
        self._E_field = torch.full((nT,), float(E), **t64)
        self._nu_field = torch.full((nT,), float(nu), **t64)
        self._rho = torch.tensor(float(rho), **t64)
        self._K_asm = CachedAffineAssembler(self.K_form, powers=(1, 3))
        self._M_asm = CachedAffineAssembler(self.M_form, powers=(1,))
        self._BA = self._load_T = None

        n = self.fe_dofs
        self.mg_coarsest_cells = mg_coarsest_cells
        self.mg = None
        if solver_method in (None, "mg"):
            from .mg import build_platesim_mg

            self.mg = build_platesim_mg(self, coarsest_cells=mg_coarsest_cells)
            solver_method = ("mg" if self.mg is not None
                             else "dense" if n <= 8000 else "cg")
        self.solver_method = solver_method
        self.inner_iters = inner_iters
        self._step_key = (dt, Nsteps)  # A's basis and the MG were made for
        self.shard_spec = None  # parallel/product.py::shard_model

        # mutable state (parity with update_t / update_f_history)
        self.t_array = torch.full((nT,), 0.1, **t64)
        self.f_history = np.zeros((self.time_levels, self.W_f.n_dofs))
        self.tip_disp_history = np.zeros(self.time_levels)
        self.opt_iter = 0
        self._tip_row = None
        self.solve_log = []

    # ------------------------------------------------------- parity setters
    def update_t(self, t_array):
        self.t_array = self._tensor(t_array).reshape(-1)

    def update_f(self, f_array):
        self.f_history[-1] = np.asarray(f_array)

    def update_f_history(self, f_history_array):
        f = np.asarray(f_history_array)
        if f.shape[0] < self.time_levels:
            pad = np.repeat(f[-1:], self.time_levels - f.shape[0], axis=0)
            f = np.concatenate([f, pad], axis=0)
        self.f_history = f[: self.time_levels]

    def update_nsteps(self, Nsteps):
        self.Nsteps = Nsteps
        self.time_levels = Nsteps + 1
        self.tip_disp_history = np.zeros(self.time_levels)
        f = self.f_history
        self.f_history = np.zeros((self.time_levels, self.W_f.n_dofs))
        n = min(len(f), self.time_levels)
        self.f_history[:n] = f[:n]
        if n < self.time_levels:
            self.f_history[n:] = f[-1]

    def set_up_tip_dofs(self, x_tip, cell_tip=None):
        """Tip z-displacement extraction row (the z component of the CG2
        displacement interpolated at x_tip)."""
        _, dofs, wts = point_eval_rows(self.pde.V_disp,
                                       [np.asarray(x_tip)])[0]
        self._tip_row = (
            torch.as_tensor(dofs.astype(np.int64) * 3 + 2,
                            device=self.device),
            torch.as_tensor(wts, dtype=torch.float64, device=self.device))

    def tip_disp(self, w):
        if self._tip_row is None:
            # default: max |z displacement| among the vertex dofs
            return torch.max(torch.abs(w[: 3 * self.nn].reshape(-1, 3)[:, 2]))
        idx, wts = self._tip_row
        return torch.dot(wts, w[idx])

    # ------------------------------------------------------------ operators
    def _tensor(self, v):
        return tensor_on(v, self.device, "PlateSim")

    def _k_params(self, t_arr):
        return {"thickness": t_arr, "E": self._E_field, "nu": self._nu_field,
                "uhat": self._zero_uhat}

    def _m_params(self, t_arr):
        return {"thickness": t_arr, "rho": self._rho}

    def shard(self, spec):
        """Split the simulator's cell-indexed operators over the ranks of a
        CellShardSpec (parallel/product.py::shard_model): K's and M's bases
        (and A's, made from them) or the direct assemblies on this rank's
        cells, and the step MG's levels."""
        self.shard_spec = spec
        cells = spec.cells_of(self.W)
        self._K_asm.shard(cells)
        self._M_asm.shard(cells)
        self._BA = None
        if self.mg is not None:
            from ...parallel.product import shard_mg_state

            shard_mg_state(self.mg, spec)

    def _op_space(self):
        """The space of the cell-indexed operators: W, or this rank's cells
        of it under a split."""
        spec = self.shard_spec
        return self.W if spec is None else spec.cells_of(self.W)

    def _split_design(self, theta):
        """theta, entering the rank's split operators (its gradient through
        them summed over the ranks); theta itself without a split."""
        if self.shard_spec is None:
            return theta
        from ...parallel.product import grad_all_reduce

        return grad_all_reduce(theta, self.shard_spec)

    def _element_mats(self, t_arr):
        """K's and M's lane-major element matrices (nd, nd, nc), assembled
        directly (nodal thickness); differentiable in t_arr. Under a split:
        this rank's cells only."""
        cells = getattr(self._op_space(), "cells", None)
        Ke = element_matrices(self.K_form, self._zero_w,
                              self._k_params(t_arr), cells=cells)
        Me = element_matrices(self.M_form, self._zero_w,
                              self._m_params(t_arr), cells=cells)
        return (Ke.permute(1, 2, 0).contiguous(),
                Me.permute(1, 2, 0).contiguous())

    def _bases(self, theta):
        """The lane-major affine bases of K (powers (1, 3)), M ((1,)) and
        A = (2/dt^2) M + K/2 ((1, 3)). K's and M's are built (and verified
        against a direct assembly) at the first design; A's and the MG
        hierarchy's are rebuilt when dt or Nsteps changes."""
        th = theta.detach()
        BK = self._K_asm.prepare(self._k_params(th))
        BM = self._M_asm.prepare(self._m_params(th))
        key = (self.dt, self.Nsteps)
        if self._BA is None or key != self._step_key:
            if key != self._step_key and self.solver_method == "mg":
                from .mg import build_platesim_mg

                self.mg = build_platesim_mg(
                    self, coarsest_cells=self.mg_coarsest_cells,
                    dtype=getattr(self.mg, "dtype", None))
                if self.shard_spec is not None:
                    from ...parallel.product import shard_mg_state

                    shard_mg_state(self.mg, self.shard_spec)
            c2 = 2.0 / self.dt ** 2
            self._BA = torch.stack([c2 * BM[0] + 0.5 * BK[0], 0.5 * BK[1]])
            self._step_key = key
        return BK, BM, self._BA

    def _operators(self, t_arr):
        ops = _StepOperators(self, t_arr)
        self.solve_log = ops.log
        return ops

    def _load_matrix(self):
        """Lane-major per-cell load matrices L (nd, nd_f, nc) with
        F_c = L_c f_c: the load is linear in the nodal force field, so its
        Jacobian, taken once by torch.func, is the whole map."""
        if self._load_T is None:
            form = self._load_form()
            jac = jacfwd(form.kernel, argnums=2)
            f0 = torch.zeros(self.W_f.n_dofs, dtype=torch.float64,
                             device=self.device)
            Lc = form.cell_values(lambda u, x, p: -jac(u, x, p)["f"],
                                  self._zero_w, {"f": f0})
            self._load_T = Lc.permute(1, 2, 0).contiguous()
            self._f_dofmap_T = torch.as_tensor(
                self.W_f.dofmap.T.astype(np.int64), device=self.device)
        return self._load_T

    def _load_form(self):
        """The load-work energy -int f.u dx of a nodal force field f."""
        pde = self.pde
        nd2 = pde.nd_disp
        VF = self.W_f

        def load_energy(u_cell, x_cell, p):
            R = pde._rules["inplane"]
            ud = u_cell[: nd2 * 3].reshape(nd2, 3)
            geo = surface_geometry(x_cell, R["geom_dphi"])
            u_q = R["d_phi"] @ ud
            f_q = _interp_vec(VF, R["f_phi"], p["f"])
            return -torch.sum(torch.sum(f_q * u_q, dim=1) * R["w"]
                              * geo["dA"])

        return FemForm(self.W, load_energy, kind="energy",
                       param_specs={"f": VF})

    def _loads(self, f_history):
        """Consistent load vectors (T, fe_dofs) of nodal force fields
        (T, n_f): differentiable in f_history."""
        L = self._load_matrix()
        fcT = f_history[:, self._f_dofmap_T]  # (T, nd_f, nc)
        FcT = torch.einsum("ijc,tjc->tic", L, fcT)
        return torch.stack([self.W.scatter_add_T(Fc) for Fc in FcT])

    def assemble_load(self, f_array, t_arr=None):
        """Consistent load vector of the nodal force field f (linear in
        f)."""
        return self._loads(self._tensor(f_array).reshape(1, -1))[0]

    def self_weight_vector(self, t_arr):
        g_factor = -1.0 if self.g_factor is None else self.g_factor
        form = self.pde.self_weight_load(g_factor * 9.81)
        rho_field = torch.full((self.num_var,), float(self.rho),
                               dtype=torch.float64, device=self.device)
        return -assemble_residual(form, self._zero_w,
                                  {"thickness": t_arr, "density": rho_field})

    def _all_loads(self, t_arr, f_history):
        F_all = self._loads(self._tensor(f_history))
        if self.add_self_weight:
            F_all = F_all + self.self_weight_vector(t_arr)[None, :]
        return F_all

    def _step(self, ops, theta, w_old, wdot_old, F_i):
        dt = self.dt
        b = self.free_mask * (
            F_i + ops.M((2.0 / dt ** 2) * w_old + (2.0 / dt) * wdot_old)
            - 0.5 * ops.K(w_old))
        w = _StepSolve.apply(b, ops.design, ops)
        wdot = (2.0 / dt) * (w - w_old) - wdot_old
        return w, wdot, b

    # ------------------------------------------------------------- simulate
    def simulate(self, t_arr, f_history, with_residuals=False):
        """Differentiable transient solve.

        t_arr: thickness (DG0); f_history: (time_levels, n_f) nodal force
        history (row 0 is the initial level and unused). Returns the
        w_history (time_levels, fe_dofs); with `with_residuals=True` also
        the per-step relative residuals of the step solves
        (time_levels - 1,)."""
        theta = self._tensor(t_arr)
        ops = self._operators(theta)
        F_all = self._all_loads(theta, f_history)
        w = torch.zeros(self.fe_dofs, dtype=torch.float64, device=self.device)
        wdot = torch.zeros_like(w)
        hist, res = [w], []
        for F_i in F_all[1:]:
            w, wdot, b = self._step(ops, theta, w, wdot, F_i)
            hist.append(w)
            if with_residuals:
                res.append(ops.residual(b, w))
        wh = torch.stack(hist)
        if with_residuals:
            return wh, torch.stack(res)
        return wh

    def simulate_outputs(self, t_arr, f_history, segment_len=None,
                         with_residuals=False, stress_pnorm=None):
        """Long-horizon transient solve with online outputs and no
        (time_levels, fe_dofs) history: the time loop runs in segments,
        each wrapped in torch.utils.checkpoint, so the backward keeps the
        segment boundary states and recomputes one segment at a time.

        The per-step strain energy is the energy form, as in the history
        path (strain_energy): the JAX package's 0.5 w^T K w by the
        operator equals it in exact arithmetic, but K w cancels to ~1e-8
        relative on shear-stiff plates (the gust workload: 1.5e-8 on one
        trajectory, tools/transient_energy_forms.py), while the form sums
        squared strains. segment_len
        defaults to the divisor of N_t nearest sqrt(N_t). stress_pnorm: optional (m, rho), which adds the per-step p-norm
        stress functional. Returns a dict: total_strain_energy,
        energy_history (N_t,), tip_history (N_t,), w_final, wdot_final
        [, pnorm_history] [, res_history]."""
        theta = self._tensor(t_arr)
        ops = self._operators(theta)
        steps = self._all_loads(theta, f_history)[1:]
        n_t = steps.shape[0]
        if segment_len is None:
            target = max(1, int(np.sqrt(n_t)))
            divisors = [d for d in range(1, n_t + 1) if n_t % d == 0]
            segment_len = min(divisors, key=lambda d: abs(d - target))
        if n_t % segment_len != 0:
            raise ValueError(
                f"segment_len={segment_len} must divide N_t={n_t}")
        pn_form = None
        if stress_pnorm is not None:
            m_pn, rho_pn = stress_pnorm
            pn_form = self.pde.pnorm_stress_form(m=m_pn, rho=rho_pn)

        def run_segment(w, wdot, F_seg, theta):
            outs = []
            for F_i in F_seg:
                w, wdot, b = self._step(ops, theta, w, wdot, F_i)
                o = [self.strain_energy(w, theta), self.tip_disp(w)]
                if pn_form is not None:
                    o.append(assemble_scalar(pn_form, w,
                                             self._k_params(theta)))
                if with_residuals:
                    o.append(ops.residual(b, w))
                outs.append(torch.stack(o))
            return w, wdot, torch.stack(outs)

        w = torch.zeros(self.fe_dofs, dtype=torch.float64, device=self.device)
        wdot = torch.zeros_like(w)
        seg_outs = []
        for s in range(0, n_t, segment_len):
            args = (w, wdot, steps[s: s + segment_len], theta)
            if torch.is_grad_enabled():
                w, wdot, o = checkpoint(run_segment, *args,
                                        use_reentrant=False)
            else:
                w, wdot, o = run_segment(*args)
            seg_outs.append(o)
        outs = torch.cat(seg_outs)  # (N_t, n_outputs)
        out = {"total_strain_energy": torch.sum(outs[:, 0]),
               "energy_history": outs[:, 0], "tip_history": outs[:, 1],
               "w_final": w, "wdot_final": wdot}
        idx = 2
        if pn_form is not None:
            out["pnorm_history"] = outs[:, idx]
            idx += 1
        if with_residuals:
            out["res_history"] = outs[:, idx].detach()
        return out

    # ----------------------------------------------------- parity interface
    def SVK_residual(self):
        """The step residual as a callable r(w, w_old, wdot_old, t_arr, f)
        for inspection and testing."""
        dt = self.dt

        def residual(w, w_old, wdot_old, t_arr, f):
            theta = self._split_design(self._tensor(t_arr))
            W = self._op_space()
            if self.element_wise_thickness:
                BK, BM, _ = self._bases(theta)
                K = AffineOperator(BK, (1, 3), theta, W)
                M = AffineOperator(BM, (1,), theta, W)
            else:
                Ke, Me = self._element_mats(theta)
                K = _ElementOperator(Ke, W)
                M = _ElementOperator(Me, W)
            wdot = (2.0 / dt) * (w - w_old) - wdot_old
            wddot = (wdot - wdot_old) / dt
            F = self.assemble_load(f)
            if self.add_self_weight:
                F = F + self.self_weight_vector(theta)
            return M(wddot) + K(0.5 * (w + w_old)) - F

        return residual

    def solve_dynamic_problem(self, residual=None, saving_outputs=False,
                              PATH=None, timing=False):
        """Run the transient simulation with the stored thickness and force
        history; returns w_output (fe_dofs, time_levels), the reference
        layout. Warns when a step solve's relative residual exceeds
        1e-6."""
        t0 = time.perf_counter()
        with torch.no_grad():
            wh, rrels = self.simulate(self.t_array, self.f_history,
                                      with_residuals=True)
        self.w_history = wh
        self.step_residual_history = rrels.cpu().numpy()
        max_rrel = float(np.max(self.step_residual_history))
        if max_rrel > 1e-6:
            warnings.warn(
                f"transient step solver: max relative residual {max_rrel:.3e}"
                " exceeds 1e-6 — increase inner_iters or refine the"
                " preconditioner", stacklevel=2)
        self.tip_disp_history = np.asarray(
            [float(self.tip_disp(w)) for w in wh])
        if timing:
            print(f"Dynamic simulation wall time: {time.perf_counter()-t0}")
        if saving_outputs:
            PATH = PATH or "solutions/"
            os.makedirs(PATH + "records", exist_ok=True)
            with torch.no_grad():
                se = self.strain_energy_history(wh, self.t_array)
            np.save(PATH + f"records/strain_energy_opt_{self.opt_iter}",
                    se.cpu().numpy())
            np.save(PATH + f"records/tip_disp_opt_{self.opt_iter}",
                    self.tip_disp_history)
            self.opt_iter += 1
        return wh.cpu().numpy().T

    # ------------------------------------------------------------- outputs
    def strain_energy(self, w, t_arr):
        return assemble_scalar(self.K_form, w, self._k_params(t_arr))

    def strain_energy_history(self, w_history, t_arr):
        return torch.stack([self.strain_energy(w, t_arr) for w in w_history])

    def assembleStrainEnergy(self, w):
        return float(self.strain_energy(self._tensor(w), self.t_array))

    def volume(self, t_arr):
        return assemble_scalar(self.pde.volume_form(), self._tensor(t_arr),
                               {"uhat": self._zero_uhat})

    def pnorm_stress(self, w, t_arr, m=1e-6, rho=100):
        form = self.pde.pnorm_stress_form(m=m, rho=rho)
        return assemble_scalar(form, w, self._k_params(t_arr))

    def von_Mises_stress(self, w, t_arr):
        project, _ = self.pde.von_mises_dg1_projection()
        return project(w, self._k_params(t_arr))
