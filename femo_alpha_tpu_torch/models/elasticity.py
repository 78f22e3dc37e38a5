"""2D plane-stress linear elasticity with a thickness design field (port
of femo_alpha_tpu/models/elasticity.py): energy 0.5 t sigma(eps):eps with
an isotropic plane-stress material, compliance and volume outputs,
differentiable in the thickness and the load."""

from __future__ import annotations

import numpy as np
import torch

from ..assembly.assemble import FemForm
from ..assembly.geometry import map_gradients
from ..device import resolve_device, tensor_on
from ..fea import FEA, FEAModel
from ..spaces import FunctionSpace, locate_dofs_geometric


class ElasticityModel:
    """Cantilever-style plane-stress elasticity: clamped at bc_func, loaded
    by a nodal (CG1) force-density field."""

    def __init__(self, mesh, E=1.0, nu=0.3, degree=2, bc_func=None,
                 solver_opts=None, device=None):
        """degree=2 (default) avoids the shear locking that linear elements
        exhibit on bending-dominated problems."""
        self.mesh = mesh
        self.device = dev = resolve_device(device)
        self.V = FunctionSpace(mesh, "P", degree, value_size=2)
        self.VF = FunctionSpace(mesh, "P", 1, value_size=2)  # nodal forces
        self.T = FunctionSpace(mesh, "DG", 0)
        tab = self.V.tabulate(quad_degree=2 * degree)
        tab_f = self.VF.tabulate(points=tab.points, weights=tab.weights)
        phi = torch.as_tensor(tab.phi, dtype=torch.float64, device=dev)
        phi_f = torch.as_tensor(tab_f.phi, dtype=torch.float64, device=dev)
        lam = E * nu / (1 - nu * nu)
        mu = E / (2 * (1 + nu))

        def energy(u_cell, x_cell, p):
            dphi_x, wdet = map_gradients(x_cell, tab)
            uc = u_cell.reshape(-1, 2)
            g = torch.einsum("ai,qag->qig", uc, dphi_x)  # (nq, 2, 2)
            eps = 0.5 * (g + g.transpose(1, 2))
            tr = eps[:, 0, 0] + eps[:, 1, 1]
            W = 0.5 * lam * tr ** 2 + mu * torch.einsum("qij,qij->q", eps,
                                                        eps)
            fq = phi_f @ p["f"].reshape(-1, 2)
            uq = phi @ uc
            t = p["thickness"][0]
            return torch.sum(wdet * (t * W - torch.sum(fq * uq, dim=1)))

        form = FemForm(self.V, energy, kind="energy",
                       param_specs={"thickness": self.T, "f": self.VF})
        fea = FEA(mesh, device=dev)
        fea.add_input("thickness", self.T)
        fea.add_input("f", self.VF)
        fea.add_state("u", form, arguments=["thickness", "f"],
                      solver_opts=solver_opts or {"method": "cg",
                                                  "tol": 1e-12})
        bc_func = bc_func or (lambda x: np.abs(x[:, 0]) < 1e-12)
        fea.add_strong_bc(locate_dofs_geometric(self.V, bc_func), 0.0)
        nf = self.VF.n_dofs
        # vertex dofs come first in the P-degree dof layout, so u's nodal
        # block aligns with the CG1 force vector
        fea.add_output(
            "compliance",
            fn=lambda vals: torch.dot(vals["f"], vals["u"][:nf]))
        areas = torch.as_tensor(_cell_areas(mesh), dtype=torch.float64,
                                device=dev)
        fea.add_output("volume",
                       fn=lambda vals: torch.dot(areas, vals["thickness"]))
        self.fea = fea
        self.model = FEAModel(fea=[fea])

    def evaluate(self, thickness, f):
        return self.model.evaluate(
            {"thickness": tensor_on(thickness, self.device,
                                    "ElasticityModel"),
             "f": tensor_on(f, self.device, "ElasticityModel")})


def _cell_areas(mesh):
    x = mesh.cell_coords()
    if mesh.cell_type == "triangle":
        a = x[:, 1] - x[:, 0]
        b = x[:, 2] - x[:, 0]
        return 0.5 * np.abs(a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0])
    # quad: split into two triangles
    a = x[:, 1] - x[:, 0]
    b = x[:, 2] - x[:, 0]
    c = x[:, 3] - x[:, 0]
    t1 = 0.5 * np.abs(a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0])
    t2 = 0.5 * np.abs(b[:, 0] * c[:, 1] - b[:, 1] * c[:, 0])
    return t1 + t2
