"""RMShellModel: one-call Reissner-Mindlin shell solver.

Port of the strong-BC structured-mesh path of
femo_alpha_tpu/models/rm_shell/model.py::RMShellModel:

    RMShellModel(mesh, shell_bc_func, element_wise_material=True,
                 PENALTY_BC=False).evaluate(f, thickness, E, nu, density)

returns a VariableGroup with disp_solid, compliance and mass;
`out.compliance.backward()` fills thickness.grad through the
implicit-function adjoint. The solve is PCG preconditioned by the
geometric-MG V-cycle, with the fine operator and every MG level
re-assembled per design through the affine basis (K2), and every operator
application through the fused constrained operator (constrained_matvec_T).

Configurations that are not ported raise NotImplementedError
(ROADMAP.md, Queue 1): penalty BCs, unstructured meshes, small dense
solves, composite laminates, nodal (CG1) material fields, mesh tags,
nodal forces (is_pressure=False) and the mesh-motion input node_disp.
They raise before the device is looked at. The model runs on the CUDA card
unless `device` names another; without a card and without `device` it
raises (pass device="cpu" for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from ...fea import FEA, FEAModel
from .mg import ShellMGPrecond, build_shell_mg, can_coarsen, strong_bc_dofs
from .pde import RMShellPDE


def _not_ported(what):
    return NotImplementedError(
        f"RMShellModel: {what} is not ported to femo_alpha_tpu_torch yet "
        "(see ROADMAP.md, Queue 1)")


class RMShellModel:
    def __init__(self, mesh, shell_bc_func=None, element_wise_material=False,
                 PENALTY_BC=True, mesh_tags=None,
                 elementwise_pressure=False, element_type="CG2CG1",
                 solver_opts=None, inplane_deg=4, shear_deg=4,
                 composite_clt=None, device=None, dtype=torch.float64):
        if shell_bc_func is None:
            raise ValueError(
                "Please provide the shell bc location function.\n"
                "Example: def ClampedBoundary(x): return x[:, 1] < 0.0")
        if PENALTY_BC:
            raise _not_ported("PENALTY_BC=True (penalty BCs with the band "
                              "Cholesky preconditioner)")
        if not getattr(mesh, "structured", False):
            raise _not_ported("an unstructured mesh")
        if composite_clt is not None:
            raise _not_ported("composite_clt")
        if not element_wise_material:
            raise _not_ported("element_wise_material=False")
        if mesh_tags is not None:
            raise _not_ported("mesh_tags (per-tag stress outputs)")
        if solver_opts is not None:
            raise _not_ported("custom solver_opts")
        if dtype != torch.float64:
            raise _not_ported(f"dtype={dtype} (the solve runs in f64)")
        if element_type != "CG2CG1":
            raise _not_ported(f"element_type={element_type!r}")
        # CG2(vec3) x CG1(vec3) dofs of the structured nx x ny quad mesh
        nx, ny = mesh.nx, mesh.ny
        n = 3 * (2 * nx + 1) * (2 * ny + 1) + 3 * (nx + 1) * (ny + 1)
        if n <= 6000:
            raise _not_ported(f"the dense direct solve (n_dofs={n} <= 6000)")
        if not can_coarsen(nx, ny):
            raise _not_ported(f"a mesh of {nx}x{ny} cells without a "
                              "multigrid hierarchy")
        self.mesh = mesh
        self.shell_bc_func = shell_bc_func
        self.element_wise_material = element_wise_material
        self.elementwise_pressure = elementwise_pressure
        self.element_type = element_type
        self.inplane_deg, self.shear_deg = inplane_deg, shear_deg
        self.nel = mesh.n_cells
        self.nn = mesh.n_nodes
        self.device = resolve_device(device)
        self.dtype = dtype
        self.set_up_fea()

    def set_up_fea(self):
        pde = self.shell_pde = RMShellPDE(
            self.mesh, element_wise_material=self.element_wise_material,
            elementwise_pressure=self.elementwise_pressure,
            element_type=self.element_type, inplane_deg=self.inplane_deg,
            shear_deg=self.shear_deg, device=self.device)
        n = pde.W.n_dofs
        fea = FEA(self.mesh, dtype=self.dtype, device=self.device)
        residual_form = pde.make_residual_form()
        mg = build_shell_mg(pde, self.shell_bc_func, device=self.device)
        opts = {"tol": 1e-11, "maxiter": 20 * int(n ** 0.5),
                "precond_factory": ShellMGPrecond(mg)}
        self.mg = mg
        for name, space in [("thickness", pde.VT), ("F_solid", pde.VF),
                            ("E", pde.VT), ("nu", pde.VT),
                            ("density", pde.VT), ("uhat", pde.VU)]:
            fea.add_input(name, space)

        # the MID-plane shell stiffness is exactly h*M1 + h^3*M3 per cell:
        # each linearization re-assembles with one K2 combine
        from ...assembly.affine import CachedAffineAssembler

        emf = CachedAffineAssembler(residual_form)
        fea.add_state("disp_solid", residual_form,
                      arguments=["thickness", "F_solid", "E", "nu", "uhat"],
                      solver_opts=opts, element_matrices_fn=emf)
        fea.add_strong_bc(strong_bc_dofs(pde, self.shell_bc_func), 0.0)
        fea.add_output("compliance", form=pde.compliance_form(),
                       arguments=["disp_solid", "thickness", "uhat"])
        fea.add_output("mass", form=pde.mass_form(),
                       arguments=["thickness", "density", "uhat"])
        self.fea = fea
        self.model = FEAModel(fea=[fea])

    def _tensor(self, v):
        if isinstance(v, torch.Tensor):
            # the operators, MG hierarchy and bases live on self.device:
            # a tensor elsewhere is the caller's mistake, never moved
            dev = self.device
            if v.device.type != dev.type or (
                    dev.index is not None and v.device.index != dev.index):
                raise ValueError(
                    f"RMShellModel was built on {dev} but an input lies on "
                    f"{v.device}: pass device= to RMShellModel")
            return v.to(dtype=self.dtype).reshape(-1)
        return torch.as_tensor(np.asarray(v), dtype=self.dtype,
                               device=self.device).reshape(-1)

    def evaluate(self, force_vector, thickness, E, nu, density,
                 node_disp=None, is_pressure=True):
        """Inputs as tensors or arrays (structured meshes keep the caller's
        node and cell ordering). Returns a VariableGroup of tensors with
        disp_solid, compliance and mass, differentiable end to end."""
        if not is_pressure:
            raise _not_ported("is_pressure=False (force-to-pressure map)")
        if node_disp is not None:
            raise _not_ported("node_disp (mesh-motion shape input)")
        inputs = {
            "thickness": self._tensor(thickness),
            "E": self._tensor(E),
            "nu": self._tensor(nu),
            "density": self._tensor(density),
            "F_solid": self._tensor(force_vector),
            "uhat": torch.zeros(3 * self.nn, dtype=self.dtype,
                                device=self.device),
        }
        return self.model.evaluate(inputs)
