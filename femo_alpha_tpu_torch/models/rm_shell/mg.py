"""Geometric-multigrid hierarchy construction for RM shells on structured
meshes.

Port of femo_alpha_tpu/models/rm_shell/mg.py: re-discretizes the shell PDE
on a nested StructuredQuadMesh hierarchy, coarsens the parameter fields by
space kind (DG0 cell means, CG1 vertex injection), and re-assembles each
level per design: through its own affine basis (h*M1 + h^3*M3, the K2
combine) for element-wise material on the MID plane without a laminate,
directly (torch.func) otherwise — nodal material, the BOT plane or a
composite laminate, whose operator is not h*M1 + h^3*M3 per cell (the
reference's affine=False branch). A laminate is coarsened with the levels
by 2x2 cell means of its A/B/D/A_s (`_coarsen_composite`). Every level is
lane-major, so each smoother step, residual and Lanczos matvec is one
application of the fused constrained operator.

`dtype=torch.float32` builds the JAX package's f32 hierarchy (its TPU
configuration, selected on the CPU by FEMO_MG_F32=1): each coarser level
an f32 RMShellPDE and an f32 affine basis assembled from f32 forms, the
whole V-cycle state in f32 (GeometricMG.setup(dtype=)), its passes on the
f32 builds of the fused operator and K2; ShellMGPrecond(mg, dtype=) casts
the vector to f32 and back around each cycle. The default stays f64.
"""

from __future__ import annotations

import numpy as np
import torch

from ...assembly.affine import CachedAffineAssembler
from ...assembly.assemble import make_constrained_matvec_T
from ...assembly.bc import DirichletBC, combine_bcs
from ...device import resolve_device
from ...solvers.multigrid import GeometricMG
from ...spaces import locate_dofs_geometric


def _coarsen_dg0(a, nx, ny, vs):
    return a.reshape(nx // 2, 2, ny // 2, 2, vs).mean(dim=(1, 3)).reshape(-1)


def _coarsen_cg1(a, nx, ny, vs):
    return a.reshape(nx + 1, ny + 1, vs)[::2, ::2].reshape(-1)


def _field_coarsener(space, nx, ny):
    vs = space.value_size
    if space.family == "DG" and space.degree == 0:
        return lambda a: _coarsen_dg0(a, nx, ny, vs)
    if space.degree == 1:
        return lambda a: _coarsen_cg1(a, nx, ny, vs)
    raise ValueError(f"no coarsener for {space.family}{space.degree}")


def strong_bc_dofs(pde, bc_func):
    """Mixed-space dofs (disp and rot) whose coordinates satisfy bc_func."""
    d1 = locate_dofs_geometric(pde.V_disp, bc_func)
    d2 = locate_dofs_geometric(pde.V_rot, bc_func)
    return np.concatenate([d1, d2 + pde.V_disp.n_dofs])


def can_coarsen(nx, ny, coarsest_cells=256):
    """Whether an nx x ny structured mesh has a coarser MG level."""
    return nx % 2 == 0 and ny % 2 == 0 and (nx // 2) * (ny // 2) >= \
        coarsest_cells


def build_shell_mg(pde, bc_func, coarsest_cells=256, dtype=None, degree=6,
                   lmin_ratio=0.06, asm_chunk=8192, device=None, cycle="V",
                   smoother="block_jacobi"):
    """GeometricMG for an RMShellPDE on a StructuredQuadMesh, or None when
    the mesh cannot be coarsened at least once (odd dims / already small).
    dtype: the precision of the coarser levels' forms and bases (None: f64;
    torch.float32: the f32 hierarchy; pass the same dtype to
    ShellMGPrecond). device: where the levels live (the solve's device);
    None means the CUDA card. cycle ("V" or "W") and smoother
    ("block_jacobi" or "schwarz") go to the GeometricMG."""
    from ...mesh import StructuredQuadMesh
    from .pde import RMShellPDE

    device = resolve_device(device)
    mesh = pde.mesh
    if not getattr(mesh, "structured", False):
        return None
    c = np.asarray(mesh.coords)
    p0 = (float(c[:, 0].min()), float(c[:, 1].min()))
    p1 = (float(c[:, 0].max()), float(c[:, 1].max()))

    def build_level(nx_k, ny_k, composite_k):
        mesh_k = StructuredQuadMesh(nx_k, ny_k, p0, p1, gdim=mesh.gdim)
        pde_k = RMShellPDE(
            mesh_k, element_wise_material=pde.element_wise_material,
            elementwise_pressure=pde.elementwise_pressure,
            element_type=pde.element_type, inplane_deg=pde.inplane_deg,
            shear_deg=pde.shear_deg,
            bot_plane=pde.bot_plane, composite=composite_k, device=device,
            dtype=dtype)
        free_k, _ = combine_bcs(
            pde_k.W.n_dofs, [DirichletBC(strong_bc_dofs(pde_k, bc_func))],
            dtype=torch.float64, device=device)
        return pde_k, free_k

    if not can_coarsen(mesh.nx, mesh.ny, coarsest_cells):
        return None

    affine = (pde.element_wise_material and pde.composite is None
              and not pde.bot_plane)
    levels = []
    nx_k, ny_k = mesh.nx, mesh.ny
    comp_k = pde.composite
    pde_k, free_k = build_level(nx_k, ny_k, comp_k)
    while True:
        # verify=False: these bases only feed the V-cycle (preconditioner
        # quality, not solution accuracy); the fine operator's basis in
        # RMShellModel keeps its verify
        asm_k = CachedAffineAssembler(pde_k.make_residual_form(),
                                      chunk=asm_chunk, dtype=dtype,
                                      verify=False)

        def make_Ae(p, asm_k=asm_k):
            # without a basis (nodal material, the BOT plane, a laminate,
            # or a geometry parameter that requires grad, see
            # ShellMGPrecond.prepare) the level is assembled directly
            q = {k: v for k, v in p.items() if k != "_affine_basis"}
            basis = p.get("_affine_basis")
            if basis is None:
                return asm_k.direct(None, q)
            return asm_k(None, q, basis=basis)

        lev = {"space": pde_k.W, "free": free_k, "make_Ae": make_Ae,
               "asm": asm_k}
        if affine:
            lev["affine_asm"] = asm_k
        levels.append(lev)
        if not can_coarsen(nx_k, ny_k, coarsest_cells):
            break
        cT = _field_coarsener(pde_k.VT, nx_k, ny_k)
        cF = _field_coarsener(pde_k.VF, nx_k, ny_k)
        cU = _field_coarsener(pde_k.VU, nx_k, ny_k)

        def coarsen(p, cT=cT, cF=cF, cU=cU):
            return {"thickness": cT(p["thickness"]), "E": cT(p["E"]),
                    "nu": cT(p["nu"]), "uhat": cU(p["uhat"]),
                    "F_solid": torch.zeros_like(cF(p["F_solid"]))}

        lev["coarsen"] = coarsen
        if comp_k is not None:
            comp_k = _coarsen_composite(comp_k, nx_k, ny_k)
        nx_k, ny_k = nx_k // 2, ny_k // 2
        pde_k, free_k = build_level(nx_k, ny_k, comp_k)

    return GeometricMG(levels, make_constrained_matvec_T, degree=degree,
                       lmin_ratio=lmin_ratio, cycle=cycle, smoother=smoother)


def _coarsen_composite(composite, nx, ny):
    """2x2 cell means of the per-cell CLT tensors (DG0 semantics, the
    cell order of _coarsen_dg0), in numpy f64."""
    from .material import CompositeCLT

    def c(a):
        s = a.shape[1:]
        return a.reshape(nx // 2, 2, ny // 2, 2, *s).mean(
            axis=(1, 3)).reshape(-1, *s)

    return CompositeCLT(c(composite.A), c(composite.B), c(composite.D),
                        c(composite.As))


def shell_mg_precond_factory(mg, dtype=None):
    """A plain precond_factory for ImplicitPDE's solver_opts: it sets the
    hierarchy up for the current parameters at each linearization (every
    level assembled from the parameters, the fine one included) and
    returns the V-cycle application. dtype: the hierarchy's precision
    (None: f64, the default; torch.float32 with a hierarchy built by
    build_shell_mg(dtype=torch.float32): the vector is cast to f32 and
    back around each cycle). Under shard_model its `shard_state` splits
    the hierarchy: each setup then builds every level, the fine one
    included, on the rank's cells."""
    return _ShellMGFactory(mg, dtype)


class _ShellMGFactory:
    _KEYS = ("thickness", "E", "nu", "uhat", "F_solid")

    def __init__(self, mg, dtype):
        self.mg, self.dtype = mg, dtype

    def __call__(self, u, params):
        state = self.mg.setup({k: params[k] for k in self._KEYS},
                              dtype=self.dtype)
        return lambda v: _cycle_in(self.mg, state, v)

    def shard_state(self, spec):
        """Split the hierarchy over the ranks of a CellShardSpec
        (parallel/product.py::shard_mg_state), as ShellMGPrecond does."""
        from ...parallel.product import shard_mg_state

        shard_mg_state(self.mg, spec)


def _cycle_in(mg, state, v):
    """One cycle of a GeometricMG state in the state's dtype, returned in
    v's (the vector cast to an f32 state's dtype and back)."""
    sdt = state["Ae"][0].dtype
    if sdt == v.dtype:
        return mg.apply(state, v)
    return mg.apply(state, v.to(sdt)).to(v.dtype)


class ShellMGPrecond:
    """Split-protocol preconditioner for ImplicitPDE: `prepare` builds (or
    reuses) the per-level affine bases, `setup_state` makes the V-cycle
    state for the current design, `apply_state` applies one V-cycle. The
    forward solve's state is reused by the adjoint solve. dtype: the
    hierarchy's precision (see build_shell_mg); the vector is cast to it
    and back around each cycle."""

    _KEYS = ("thickness", "E", "nu", "uhat", "F_solid")

    def __init__(self, mg: GeometricMG, dtype=None):
        self.mg = mg
        self.dtype = dtype

    def prepare(self, params, grad_keys=frozenset()):
        """Per-level affine bases. Level 0's entry is None: setup_state
        always hands the hierarchy the fine operator itself (Ae0), so the
        fine level never re-assembles from a basis of its own. () when a
        level has no basis (nodal material, or a geometry parameter in
        grad_keys): every coarse level is then assembled directly."""
        p = {k: params[k] for k in self._KEYS if k in params}
        bases = []
        for k, lev in enumerate(self.mg.levels):
            if k > 0:
                if "affine_asm" not in lev:
                    return ()
                b = lev["affine_asm"].prepare(p, grad_keys)
                if b is None:
                    return ()
                bases.append(b)
            else:
                bases.append(None)
            if "coarsen" in lev:
                p = lev["coarsen"](p)
        return tuple(bases)

    def setup_state(self, u, params, ops_Ae, aux):
        """The hierarchy's state in `dtype` (None: f64). The fine level is
        the solve's own operator, cast to that dtype (an f32-stored fine
        operator, storage="f32", enters an f64 hierarchy upcast)."""
        p = {k: params[k] for k in self._KEYS if k in params}
        return self.mg.setup(p, Ae0=ops_Ae[0],
                             dtype=self.dtype or torch.float64,
                             bases=aux if aux else None)

    def shard_state(self, spec):
        """Split the hierarchy over the ranks of a CellShardSpec
        (parallel/product.py::shard_mg_state): every later `prepare` builds
        each coarser level's basis on this rank's cells, and `setup_state`
        the rank's cells of every level (the fine one is the solve's own,
        already split), with the smoother blocks and the coarse matrix
        summed over the ranks."""
        from ...parallel.product import shard_mg_state

        shard_mg_state(self.mg, spec)

    def apply_state(self, state, v):
        return _cycle_in(self.mg, state, v)
