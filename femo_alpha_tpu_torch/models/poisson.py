"""Poisson models with a design-field conductivity (port of
femo_alpha_tpu/models/poisson.py).

PoissonModel: -div(kappa grad u) = f with Dirichlet BCs, differentiable
in kappa and f. NonlinearPoissonModel: -div(kappa grad u) + kappa u^3 = f
through the Newton path, from the convex energy
E(u) = int kappa (|grad u|^2 / 2 + u^4 / 4) - f u dx. Both solve through
ImplicitPDE on the fused operator with the JAX package's solver options
(point-Jacobi CG at tol 1e-12 / 1e-13).
"""

from __future__ import annotations

import numpy as np
import torch

from ..assembly.assemble import FemForm
from ..assembly.geometry import map_gradients
from ..device import resolve_device, tensor_on
from ..fea import FEA, FEAModel
from ..spaces import FunctionSpace, locate_dofs_geometric


def _table(a, device):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=device)


class PoissonModel:
    def __init__(self, mesh, degree=1, kappa_space="DG", bc_func=None,
                 solver_opts=None, device=None):
        self.mesh = mesh
        self.device = dev = resolve_device(device)
        self.V = FunctionSpace(mesh, "P", degree)
        self.K = FunctionSpace(mesh, kappa_space, 0 if kappa_space == "DG"
                               else 1)
        tab = self.V.tabulate(quad_degree=2 * degree + 2)
        tab_k = self.K.tabulate(points=tab.points, weights=tab.weights)
        phi = _table(tab.phi, dev)
        phi_k = _table(tab_k.phi, dev)
        is_dg0 = kappa_space == "DG"

        def energy(u_cell, x_cell, p):
            dphi_x, wdet = map_gradients(x_cell, tab)
            gu = torch.einsum("qag,a->qg", dphi_x, u_cell)
            kq = p["kappa"][0] if is_dg0 else phi_k @ p["kappa"]
            fq = phi @ p["f"]
            uq = phi @ u_cell
            return torch.sum(
                wdet * (0.5 * kq * torch.sum(gu * gu, dim=1) - fq * uq))

        form = FemForm(self.V, energy, kind="energy",
                       param_specs={"kappa": self.K, "f": self.V})
        fea = FEA(mesh, device=dev)
        fea.add_input("kappa", self.K)
        fea.add_input("f", self.V)
        fea.add_state("u", form, arguments=["kappa", "f"],
                      solver_opts=solver_opts or {"method": "cg",
                                                  "tol": 1e-12})
        bc_func = bc_func or (lambda x: _on_boundary_default(mesh, x))
        fea.add_strong_bc(locate_dofs_geometric(self.V, bc_func), 0.0)
        fea.add_output(
            "compliance", fn=lambda vals: torch.dot(vals["f"], vals["u"]))
        fea.add_output("mean_u", fn=lambda vals: torch.mean(vals["u"]))
        self.fea = fea
        self.model = FEAModel(fea=[fea])

    def evaluate(self, kappa, f):
        return self.model.evaluate(
            {"kappa": tensor_on(kappa, self.device, "PoissonModel"),
             "f": tensor_on(f, self.device, "PoissonModel")})


class NonlinearPoissonModel:
    """-div(kappa grad u) + kappa u^3 = f, u = 0 on the boundary: the
    residual is the gradient of the cell energy and the Newton Jacobian
    kappa (grad., grad.) + 3 kappa u^2 (., .) is SPD.

    Two solve surfaces: evaluate() — FEA/ImplicitPDE with newton_iters
    fixed Newton steps, differentiable (the adjoint re-linearizes at the
    returned state); solve_checked() — solvers.newton_solve with
    convergence control (raises on nonconvergence by default)."""

    def __init__(self, mesh, degree=1, bc_func=None, newton_iters=8,
                 solver_opts=None, device=None):
        self.mesh = mesh
        self.device = dev = resolve_device(device)
        self.V = FunctionSpace(mesh, "P", degree)
        self.K = FunctionSpace(mesh, "DG", 0)
        tab = self.V.tabulate(quad_degree=2 * degree + 2)
        phi = _table(tab.phi, dev)

        def energy(u_cell, x_cell, p):
            dphi_x, wdet = map_gradients(x_cell, tab)
            gu = torch.einsum("qag,a->qg", dphi_x, u_cell)
            uq = phi @ u_cell
            fq = phi @ p["f"]
            kq = p["kappa"][0]
            return torch.sum(wdet * (kq * (0.5 * torch.sum(gu * gu, dim=1)
                                           + 0.25 * uq ** 4) - fq * uq))

        form = FemForm(self.V, energy, kind="energy",
                       param_specs={"kappa": self.K, "f": self.V})
        fea = FEA(mesh, device=dev)
        fea.linear_problem = False
        fea.add_input("kappa", self.K)
        fea.add_input("f", self.V)
        fea.add_state("u", form, arguments=["kappa", "f"],
                      newton_iters=newton_iters,
                      solver_opts=solver_opts or {"method": "cg",
                                                  "tol": 1e-13})
        bc_func = bc_func or (lambda x: _on_boundary_default(mesh, x))
        fea.add_strong_bc(locate_dofs_geometric(self.V, bc_func), 0.0)
        fea.add_output(
            "compliance", fn=lambda vals: torch.dot(vals["f"], vals["u"]))
        self.fea = fea
        self.model = FEAModel(fea=[fea])

    def _params(self, kappa, f):
        return {"kappa": tensor_on(kappa, self.device, "NonlinearPoissonModel"),
                "f": tensor_on(f, self.device, "NonlinearPoissonModel")}

    def evaluate(self, kappa, f):
        return self.model.evaluate(self._params(kappa, f))

    def solve_checked(self, kappa, f, atol=1e-11, rtol=1e-11, max_it=20,
                      **kw):
        """Newton with convergence control from u = 0; returns (u, info)."""
        from ..solvers import newton_solve

        pde = self.fea.states["u"].pde
        params = {k: v.detach() for k, v in self._params(kappa, f).items()}

        def linear_step(u, r):
            return pde.make_solver(u, params).solve(r)

        with torch.no_grad():
            u0 = torch.zeros(pde.n_dofs, dtype=torch.float64,
                             device=self.device)
            return newton_solve(lambda u: pde.residual(u, params),
                                linear_step, u0, atol=atol, rtol=rtol,
                                max_it=max_it, **kw)


def _on_boundary_default(mesh, x):
    lo = mesh.coords.min(axis=0)
    hi = mesh.coords.max(axis=0)
    eps = 1e-12
    m = np.zeros(len(x), dtype=bool)
    for d in range(mesh.gdim):
        m |= (np.abs(x[:, d] - lo[d]) < eps) | (np.abs(x[:, d] - hi[d]) < eps)
    return m
