"""Geometric multigrid for the transient shell's step operator.

Port of femo_alpha_tpu/models/dynamic_rm_shell/mg.py. The implicit-midpoint
step solves A w = b with A = (2/dt^2) M + K/2, which is stiffness-dominated
at practical dt, so Jacobi-PCG needs thousands of iterations. This builds
the nested structured hierarchy of models/rm_shell/mg.py with per-level
step operators: each coarser level re-discretizes the step form
(2/dt^2) inertia + elastic/2, whose element matrices are exactly
h*M1 + h^3*M3 in the element-wise thickness, so each level re-assembles
per design through its own affine basis (one K2 combine); with nodal
thickness each level assembles the step form directly per design (the
reference's 2/dt^2 M + K/2 per level). Every level is lane-major: each
smoother step, residual and Lanczos matvec is one application of the
fused constrained operator. The fine level's operator is the PlateSim's
own (GeometricMG.setup(..., Ae0=...)). The hierarchy is f64 by default;
`build_platesim_mg(sim, dtype=torch.float32)` builds the JAX package's
f32 one (its TPU default): f32 coarser levels from f32 forms, the state
set up in f32 (the fine operator cast down), each V-cycle on the f32
kernel builds, with the step solve's vectors cast to f32 and back around
it (plate_sim.py). The hierarchy keeps its `dtype`.
"""

from __future__ import annotations

import numpy as np
import torch

from ...assembly.affine import CachedAffineAssembler
from ...assembly.assemble import FemForm, make_constrained_matvec_T
from ...assembly.bc import DirichletBC, combine_bcs
from ...solvers.multigrid import GeometricMG
from ..rm_shell.mg import _field_coarsener, can_coarsen, strong_bc_dofs


def step_form(pde, dt):
    """The step operator's energy (2/dt^2) inertia + elastic/2 on an
    RMShellPDE, with the parameters thickness, E, nu, uhat and the scalar
    rho, in the PDE's dtype."""
    c2 = 2.0 / dt ** 2
    inertia = pde.inertia_form(rho_is_param=False).energy_kernel
    elastic = pde.make_elastic_energy_kernel(with_load=False)

    def energy(u_cell, x_cell, p):
        return c2 * inertia(u_cell, x_cell, p) + 0.5 * elastic(u_cell,
                                                               x_cell, p)

    return FemForm(pde.W, energy, kind="energy",
                   param_specs={"thickness": pde.VT, "E": pde.VT,
                                "nu": pde.VT, "uhat": pde.VU, "rho": None},
                   dtype=pde.dtype)


def build_platesim_mg(sim, coarsest_cells=64, dtype=None, degree=6,
                      lmin_ratio=0.06, asm_chunk=8192):
    """GeometricMG for a PlateSim's step operator, or None if the mesh is
    not a coarsenable StructuredQuadMesh. dtype: the hierarchy's precision
    (None: f64; torch.float32: the f32 hierarchy); assign the result to
    `sim.mg` to use it.

    Level params: {"thickness": t_k}; E, nu, rho and dt are fixed PlateSim
    attributes, baked into each coarser level's step form."""
    from ...mesh import StructuredQuadMesh
    from ..rm_shell.pde import RMShellPDE

    mesh = sim.mesh
    if not getattr(mesh, "structured", False):
        return None
    if not can_coarsen(mesh.nx, mesh.ny, coarsest_cells):
        return None
    c = np.asarray(mesh.coords)
    p0 = (float(c[:, 0].min()), float(c[:, 1].min()))
    p1 = (float(c[:, 0].max()), float(c[:, 1].max()))
    dev = sim.device
    t64 = dict(dtype=torch.float64, device=dev)

    def coarser_level(nx_k, ny_k):
        pde_k = RMShellPDE(
            StructuredQuadMesh(nx_k, ny_k, p0, p1, gdim=mesh.gdim),
            element_wise_material=sim.element_wise_thickness,
            inplane_deg=sim.quad_deg,
            shear_deg=sim.quad_deg, stress_deg=sim.quad_deg, device=dev,
            dtype=dtype)
        free_k, _ = combine_bcs(
            pde_k.W.n_dofs,
            [DirichletBC(strong_bc_dofs(pde_k, sim.bc_func))], **t64)
        # verify=False: these bases only feed the V-cycle (preconditioner
        # quality, not solution accuracy); the fine operator's bases in
        # PlateSim keep their verify
        asm_k = CachedAffineAssembler(step_form(pde_k, sim.dt),
                                      chunk=asm_chunk, dtype=dtype,
                                      verify=False)
        nT = pde_k.VT.n_dofs
        consts = {"E": torch.full((nT,), float(sim.E), **t64),
                  "nu": torch.full((nT,), float(sim.nu), **t64),
                  "uhat": torch.zeros(pde_k.VU.n_dofs, **t64),
                  "rho": torch.tensor(float(sim.rho), **t64)}

        def make_Ae(p):
            q = {**consts, "thickness": p["thickness"]}
            if sim.element_wise_thickness:
                return asm_k(None, q)
            return asm_k.direct(None, q)

        return pde_k, {"space": pde_k.W, "free": free_k, "make_Ae": make_Ae,
                       "asm": asm_k}

    # the fine level's operator is the PlateSim's own, passed to
    # GeometricMG.setup as Ae0
    pde_k = sim.pde
    levels = [{"space": sim.W, "free": sim.free_mask, "make_Ae": None}]
    nx_k, ny_k = mesh.nx, mesh.ny
    while True:
        cT = _field_coarsener(pde_k.VT, nx_k, ny_k)
        levels[-1]["coarsen"] = lambda p, cT=cT: {
            "thickness": cT(p["thickness"])}
        nx_k, ny_k = nx_k // 2, ny_k // 2
        pde_k, lev = coarser_level(nx_k, ny_k)
        levels.append(lev)
        if not can_coarsen(nx_k, ny_k, coarsest_cells):
            break
    mg = GeometricMG(levels, make_constrained_matvec_T, degree=degree,
                     lmin_ratio=lmin_ratio)
    mg.dtype = dtype
    return mg
