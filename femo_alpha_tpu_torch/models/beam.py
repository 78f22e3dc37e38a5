"""Euler-Bernoulli cantilever beam with Hermite cubic elements (port of
femo_alpha_tpu/models/beam.py).

Residual int (v'')·EI(t)·u'' dx - f·v|tip with EI = E·b·t³/12, a DG0
thickness design field, a clamped (value + slope) root, compliance and
volume outputs; the SLSQP thickness study of
examples/basic_examples/beam_thickness_opt. The Hermite dof transform
(slope dofs scale with the cell length h) is applied inside the cell
kernel, so the tabulated reference tables stay static. The tip load is a
constant extra residual. By default the system (2·(nel+1) dofs) is
solved by the dense f64 Cholesky, as in the reference: no kernel runs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..assembly.assemble import FemForm
from ..device import resolve_device, tensor_on
from ..fea import FEA, FEAModel
from ..mesh import createIntervalMesh
from ..spaces import FunctionSpace


class EulerBernoulliBeamModel:
    def __init__(self, nel=50, L=1.0, E=1.0, width=0.1, tip_load=-1.0,
                 solver="dense", device=None):
        self.L, self.E, self.width = L, E, width
        self.device = dev = resolve_device(device)
        self.mesh = createIntervalMesh(nel, 0.0, L)
        self.V = FunctionSpace(self.mesh, "Hermite", 3)
        self.T = FunctionSpace(self.mesh, "DG", 0)
        tab = self.V.tabulate(quad_degree=6, with_hessian=True)
        t64 = dict(dtype=torch.float64, device=dev)
        d2phi = torch.as_tensor(tab.d2phi[:, :, 0, 0], **t64)  # (nq, 4)
        w = torch.as_tensor(tab.weights, **t64)
        Ec, b = E, width

        def energy(u_cell, x_cell, p):
            h = x_cell[1, 0] - x_cell[0, 0]
            # Hermite dof transform: physical slope dofs enter scaled by h
            one = torch.ones_like(h)
            c = u_cell * torch.stack([one, h, one, h])
            t = p["thickness"][0]
            EI = Ec * b * t ** 3 / 12.0
            upp = (d2phi @ c) / h ** 2  # physical second derivative
            return torch.sum(w * h * 0.5 * EI * upp ** 2)

        form = FemForm(self.V, energy, kind="energy",
                       param_specs={"thickness": self.T})

        # tip point load: value dof of the last node (x = L)
        F = torch.zeros(self.V.n_dofs, **t64)
        F[self.V.n_dofs - 2] = tip_load
        self._F = F

        fea = FEA(self.mesh, device=dev)
        fea.add_input("thickness", self.T)
        fea.add_state("displacements", form, arguments=["thickness"],
                      extra_residual=lambda u, p: -F,
                      solver_opts={"method": solver, "tol": 1e-14})
        # clamped root: value + slope dofs at node 0 (x = 0)
        fea.add_strong_bc(np.array([0, 1], dtype=np.int32), 0.0)
        fea.add_output("compliance",
                       fn=lambda vals: torch.dot(F, vals["displacements"]))
        # volume = int t·b·L dx
        h_cells = torch.as_tensor(np.diff(self.mesh.coords[:, 0]), **t64)
        fea.add_output(
            "volume",
            fn=lambda vals: torch.sum(vals["thickness"] * h_cells) * b * L)
        self.fea = fea
        self.model = FEAModel(fea=[fea])

    def evaluate(self, thickness):
        return self.model.evaluate(
            {"thickness": tensor_on(thickness, self.device,
                                    "EulerBernoulliBeamModel")})
