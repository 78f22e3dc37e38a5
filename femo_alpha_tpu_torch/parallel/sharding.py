"""The multi-device demo classes, as thin wrappers over the product path.

Port of femo_alpha_tpu/parallel/sharding.py. Each rank owns a contiguous
range of cells (product.CellShardSpec), assembles and applies its own
cells' element operators, and one all_reduce sums them; dof vectors stay
replicated, as the JAX package's shard_map versions do with a psum.

- `ShardedAssembler`: the residual (the rank's cells, then the sum) and a
  matrix-free operator of the rank's element matrices (the fused operator
  over its cells, then the sum).
- `ShardedShellStep`: the static shell's forward solve and compliance
  gradient, an ImplicitPDE split by product.shard_model (CG without a
  preconditioner, or with the split geometric-MG V-cycle).
- `ShardedPlateStep`: the implicit-midpoint transient with split K and M
  products and step solves, differentiated through the time loop.

The JAX package's mesh-axis bookkeeping (its divisibility assertion, the
per-level replicate-or-shard choice of `_shard_mg_state`, the
`jax.jit`-ready closures) serves XLA's partitioner and is not carried
over: every cell count splits over every rank here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..assembly.assemble import (
    FemForm,
    assemble_residual,
    element_matrices,
    make_constrained_matvec_T,
)
from ..assembly.bc import DirichletBC, combine_bcs
from .product import CellShardSpec, grad_all_reduce, make_device_mesh, \
    shard_model


class ShardedAssembler:
    """Split residual / element matrices / operator of one FemForm over
    the ranks of a DeviceMesh (make_device_mesh() when None)."""

    def __init__(self, form: FemForm, jmesh=None, axis="cells"):
        self.form = form
        self.jmesh = jmesh or make_device_mesh()
        self.axis = axis
        self.spec = CellShardSpec(self.jmesh, axis)
        self.cells = self.spec.cells_of(form.space)
        self.n_dofs = form.space.n_dofs

    def element_matrices(self, u, params):
        """This rank's cells' element matrices, lane-major (nd, nd, nc_r)."""
        Ae = element_matrices(self.form, u, params, cells=self.cells.cells)
        return Ae.permute(1, 2, 0).contiguous()

    def residual(self, u, params):
        """The assembled residual (n_dofs,): the rank's cells, then one
        all_reduce (not differentiable: the split ImplicitPDE
        differentiates its own residual)."""
        with torch.no_grad():
            rc = self.form.cell_values(self.form.kernel, u, params,
                                       chunk=16384, cells=self.cells.cells)
            return self.cells.scatter_add(rc)

    def make_matvec(self, u, params):
        """x -> A x from the rank's element matrices, computed once: the
        fused operator over the rank's cells (free = ones), then one
        all_reduce."""
        with torch.no_grad():
            Ae_T = self.element_matrices(u, params)
        ones = torch.ones(self.n_dofs, dtype=Ae_T.dtype, device=Ae_T.device)
        op = make_constrained_matvec_T(Ae_T, self.cells, ones)
        return lambda x: op(x.contiguous())


def _plate(nx, ny, device):
    from ..mesh import createRectangleMesh
    from ..models.rm_shell.pde import RMShellPDE

    mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad", gdim=3)
    pde = RMShellPDE(mesh, element_wise_material=True, inplane_deg=2,
                     shear_deg=2, stress_deg=2, device=device)
    return mesh, pde


def _free_mask(pde, bc_func, device):
    from ..models.rm_shell.mg import strong_bc_dofs

    free, _ = combine_bcs(pde.W.n_dofs,
                          [DirichletBC(strong_bc_dofs(pde, bc_func), 0.0)],
                          dtype=torch.float64, device=device)
    return free


class ShardedShellStep:
    """The multi-device static step: forward RM-shell solve and the
    gradient of the compliance F.u in the thickness, on the split
    operators. precond="jacobi" runs CG without a preconditioner, as the
    reference's class does; precond="mg" the split geometric-MG V-cycle
    (build_shell_mg with `coarsest_cells`). device: where the tensors live
    (None: the CUDA card)."""

    def __init__(self, nx=8, ny=4, jmesh=None, bc_func=None,
                 precond="jacobi", coarsest_cells=8, device=None):
        from ..adjoint.implicit import ImplicitPDE
        from ..device import resolve_device
        from ..models.rm_shell.mg import ShellMGPrecond, build_shell_mg

        if precond not in ("jacobi", "mg"):
            raise ValueError(f"ShardedShellStep: precond {precond!r} "
                             "(jacobi or mg)")
        self.device = resolve_device(device)
        self.jmesh = jmesh or make_device_mesh()
        self.mesh, pde = _plate(nx, ny, self.device)
        self.pde = pde
        bc_func = bc_func or (lambda x: x[:, 0] < 1e-12)
        self.free_mask = _free_mask(pde, bc_func, self.device)
        self.form = pde.make_residual_form()
        self.asm = ShardedAssembler(self.form, self.jmesh)
        self.n = pde.W.n_dofs
        self.mg = None
        opts = {"method": "cg", "tol": 1e-10, "pc": None, "maxiter": 2000}
        if precond == "mg":
            self.mg = build_shell_mg(pde, bc_func,
                                     coarsest_cells=coarsest_cells,
                                     device=self.device)
            if self.mg is None:
                raise ValueError(
                    "mesh cannot build an MG hierarchy (odd dims or below "
                    f"coarsest_cells={coarsest_cells})")
            opts.update(maxiter=200, precond_factory=ShellMGPrecond(self.mg))
        self.implicit = ImplicitPDE(
            self.form, self.free_mask, torch.zeros_like(self.free_mask),
            solver_opts=opts)
        shard_model(self.implicit, self.jmesh)
        t64 = dict(dtype=torch.float64, device=self.device)
        self.example_thickness = torch.full((pde.VT.n_dofs,), 0.2, **t64)
        f = torch.zeros((self.mesh.n_nodes, 3), **t64)
        f[:, 2] = 2.0
        self.example_force = f.reshape(-1)

    def _params(self, thickness, force):
        return {"thickness": thickness,
                "E": torch.full_like(thickness, 4.32e8),
                "nu": torch.zeros_like(thickness),
                "uhat": torch.zeros(self.pde.VU.n_dofs, dtype=torch.float64,
                                    device=self.device),
                "F_solid": force}

    def train_step(self, thickness, force):
        """(compliance F.u, d compliance / d thickness)."""
        th = thickness.detach().clone().requires_grad_(True)
        params = self._params(th, force)
        u = self.implicit.solve(params)
        F = -self.asm.residual(torch.zeros(self.n, dtype=torch.float64,
                                           device=self.device),
                               {k: v.detach() for k, v in params.items()}
                               ) * self.free_mask
        J = torch.dot(F, u)
        J.backward()
        return J.detach(), th.grad


class _StepOps:
    """The step solve of ShardedPlateStep for plate_sim._StepSolve: CG on
    the split constrained step operator, without a preconditioner, and the
    per-cell design cotangent of the rank's element matrices."""

    def __init__(self, design, space, free):
        self.free, self.space = free, space
        self.A_c = make_constrained_matvec_T(design.detach(), space, free)

    def solve(self, b, phase):
        from ..solvers.krylov import cg_solve

        x, _ = cg_solve(self.A_c, b, tol=1e-11, maxiter=4000)
        return x

    def design_grad(self, design, w, lam):
        from ..models.dynamic_rm_shell.plate_sim import _cell_outer

        f = self.free
        return -_cell_outer(self.space, f * lam, f * w)


class ShardedPlateStep:
    """The multi-device transient step: the implicit-midpoint RM plate
    time loop with split stiffness and consistent-mass operators
    (assembled once per call on each rank's cells), differentiated end to
    end: the total strain energy sum_t 0.5 w_t.K w_t and its gradient in
    the thickness. device: where the tensors live (None: the card)."""

    def __init__(self, nx=8, ny=4, dt=0.01, nsteps=4, jmesh=None,
                 bc_func=None, device=None):
        from ..device import resolve_device

        self.device = resolve_device(device)
        self.jmesh = jmesh or make_device_mesh()
        self.dt, self.nsteps = float(dt), int(nsteps)
        self.mesh, pde = _plate(nx, ny, self.device)
        self.pde = pde
        bc_func = bc_func or (lambda x: x[:, 0] < 1e-12)
        self.free_mask = _free_mask(pde, bc_func, self.device)
        self.kform = pde.make_residual_form()
        self.mform = pde.inertia_form()  # params: thickness, density
        self.k_asm = ShardedAssembler(self.kform, self.jmesh)
        self.m_asm = ShardedAssembler(self.mform, self.jmesh)
        self.spec = self.k_asm.spec
        self.n = pde.W.n_dofs
        t64 = dict(dtype=torch.float64, device=self.device)
        self.example_thickness = torch.full((pde.VT.n_dofs,), 0.05, **t64)
        f = np.zeros((self.mesh.n_nodes, 3))
        f[:, 2] = 500.0
        self.example_f_history = torch.as_tensor(
            np.tile(f.reshape(1, -1), (self.nsteps + 1, 1)), **t64)
        self._rho = torch.full((self.mesh.n_cells,), 10.0, **t64)

    def _k_params(self, thickness, f_vec):
        return {"thickness": thickness,
                "E": torch.full_like(thickness, 4.32e8),
                "nu": torch.zeros_like(thickness),
                "uhat": torch.zeros(self.pde.VU.n_dofs, dtype=torch.float64,
                                    device=self.device),
                "F_solid": f_vec}

    def total_strain_energy(self, thickness, f_history):
        """Differentiable total strain energy of the implicit-midpoint
        trajectory (the sum over the steps of 0.5 w^T K w)."""
        from ..models.dynamic_rm_shell.plate_sim import (
            _ElementOperator,
            _StepSolve,
        )

        dt, n, free = self.dt, self.n, self.free_mask
        W = self.k_asm.cells
        zeros = torch.zeros(n, dtype=torch.float64, device=self.device)
        th_s = grad_all_reduce(thickness, self.spec)
        zero_f = torch.zeros_like(f_history[0])
        Ke = element_matrices(self.kform, zeros, self._k_params(th_s, zero_f),
                              cells=W.cells).permute(1, 2, 0).contiguous()
        Me = element_matrices(self.mform, zeros,
                              {"thickness": th_s, "density": self._rho},
                              cells=W.cells).permute(1, 2, 0).contiguous()
        K, M = _ElementOperator(Ke, W), _ElementOperator(Me, W)
        design = (2.0 / dt ** 2) * Me + 0.5 * Ke
        ops = _StepOps(design, W, free)
        # the consistent loads: the residual at u = 0 with the force field
        # installed is exactly -F (replicated)
        F_all = [-assemble_residual(self.kform, zeros,
                                    self._k_params(thickness, f_history[i]))
                 for i in range(1, self.nsteps + 1)]
        w, wdot = zeros, zeros
        total = None
        for F_i in F_all:
            b = free * (F_i + M((2.0 / dt ** 2) * w + (2.0 / dt) * wdot)
                        - 0.5 * K(w))
            w_new = _StepSolve.apply(b, design, ops)
            wdot = (2.0 / dt) * (w_new - w) - wdot
            w = w_new
            e_t = 0.5 * torch.dot(w, K(w))
            total = e_t if total is None else total + e_t
        return total

    def train_step(self, thickness, f_history):
        """(total strain energy, its gradient in the thickness)."""
        th = thickness.detach().clone().requires_grad_(True)
        v = self.total_strain_energy(th, f_history)
        v.backward()
        return v.detach(), th.grad
