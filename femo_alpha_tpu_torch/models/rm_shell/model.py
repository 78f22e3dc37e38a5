"""RMShellModel: one-call Reissner-Mindlin shell solver.

Port of femo_alpha_tpu/models/rm_shell/model.py::RMShellModel, with
nodal (CG1, the default) or element-wise (DG0, element_wise_material=True)
material fields, isotropic on the MID plane or a composite laminate
(`composite_clt`, a material.CompositeCLT in the mesh's FE cell order):

    RMShellModel(mesh, shell_bc_func, mesh_tags=...).evaluate(
        f, thickness, E, nu, density)

returns a VariableGroup with disp_solid, disp_extracted, compliance, mass,
volume, elastic_energy, pnorm_stress, aggregated_stress, pnorm_stress_<tag>
(one per mesh tag) and the DG1 von Mises field `stress`, all
differentiable: e.g. `out.aggregated_stress.backward()` fills
thickness.grad through the implicit-function adjoint. Inputs come in the
caller's node and cell order (a mesh read from a file keeps the file's)
and are reordered to the FE order inside.

The solve, by configuration (as the reference chooses it):
- n_dofs <= 6000: a dense f64 Cholesky of the constrained matrix;
- strong BCs (PENALTY_BC=False) on a structured mesh with a multigrid
  hierarchy: PCG preconditioned by the geometric-MG V-cycle (`mg_opts`:
  extra keywords of build_shell_mg, e.g. {"cycle": "W", "smoother":
  "schwarz"});
- otherwise — penalty BCs (the default) or an unstructured mesh: PCG
  preconditioned by the f64 band Cholesky of the RCM-ordered system
  (solvers/band.py), factored once per design and reused by the adjoint;
  past the band memory guard (FEMO_BAND_MEM_GB, default 6 GB of the
  reference's estimate) by the aggregation AMG with its penalty split
  (solvers/amg.py::AMGPrecondFactory), set up once per design and reused
  by the adjoint. The reference wraps the band setup and the AMG's
  construction in catch-alls that fall back to the AMG or to point-Jacobi
  CG; the port does not: an error there raises;
- custom `solver_opts`: used verbatim by the LinearSolver (e.g.
  {"method": "gmres", "pc": "jacobi"}), as the reference uses them.
Every operator application goes through the fused constrained operator
(constrained_matvec_T: the cell block and, with penalty BCs, the facet
block). With element-wise isotropic material every per-design
re-assembly of the cell operator goes through the affine basis (K2): the
stiffness is exactly h*M1 + h^3*M3 per cell. A nodal thickness field is
not affine per cell, and with a composite laminate the stiffness is not
h*M1 + h^3*M3 (its A/B/D are fixed per cell, only drilling reads h), so
there the cell operator and every MG level (each with its
coarsened laminate) are assembled directly (torch.func) once per
linearization, and the forward and adjoint solves share them, as the
reference does (emf=None). The modal mass stays affine in element-wise h
whatever the laminate. With a laminate, E and nu reach only the drilling
term, the stresses and the DG1 projection.

Shape and load inputs: `node_disp` (n_nodes, 3), the mesh-motion field
uhat in the caller's node order, enters every form through the
deformed-configuration pullbacks J(uhat) and F(uhat); the outputs are
differentiable in it (shape gradients, no remeshing). While it requires
grad, the fine operator and every MG level are assembled directly once per
call instead of from a cached affine basis (assembly/affine.py).
`is_pressure=False` takes `force_vector` as nodal forces and maps them to
the pressure field by a differentiable solve with the VF mass matrix
(RMShellPDE.make_force_to_pressure_solver, built once per model).

Modal analysis (`evaluate_modal`, `modal_eigenvalues`): the smallest
eigenpairs of K phi = omega^2 M phi by a dense reduced eigh (n_dofs <=
6000) or by LOBPCG over the solve path's operator and preconditioner, with
eigenvalues differentiable in thickness, E, nu and density through the
Rayleigh quotient at the converged modes; `node_disp` there is a fixed
geometry.

`record` is stored, as the reference stores it (it writes nothing);
`additional_outputs` is accepted and ignored, as the reference ignores
it.

`element_type` is "CG2CG1" (the default), "CG2CR1" (triangles) or
"CG1CG1", each on every solve route above (RMShellPDE).

The solve runs in f64. The JAX package's f32 solver configuration (its
TPU default) is selected as the JAX package lets a user select it on the
CPU, read at model construction: FEMO_MG_F32=1 gives the MG route the f32
hierarchy (f32 coarse-level forms and bases, an f32 V-cycle on the
kernels' f32 builds; models/rm_shell/mg.py), FEMO_OP_STORAGE=f32 rounds
the fine operator's affine basis to f32 (combined by K2's f32 build,
applied in f64 arithmetic as the JAX package applies it on the CPU). The
band and AMG routes stay f64 here, as the JAX package's do off the TPU;
their f32 configurations are BandCholPrecond(dtype=) and
AMGPrecondFactory(dtype=). Not ported, raising NotImplementedError
before the device is looked at: a `dtype` other than f64 for the model's
own inputs and state, and FEMO_OP_STORAGE=df. The model runs on the CUDA card unless
`device` names another; without a card and without `device` it raises
(pass device="cpu" for the CPU).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ...assembly.affine import CachedAffineAssembler
from ...assembly.assemble import (
    assemble_residual,
    assemble_scalar,
    assemble_scalar_subset,
    make_constrained_matvec_T,
)
from ...device import resolve_device, tensor_on
from ...fea import FEA, FEAModel
from ...fea.model import VariableGroup
from ...solvers.amg import AMGPrecondFactory
from ...solvers.band import band_precond_factory
from ...solvers.linear import dense_from_blocks
from ...solvers.eigen import dense_generalized_eigh, lobpcg
from ...utils.logging import log
from .mg import ShellMGPrecond, build_shell_mg, strong_bc_dofs
from .pde import RMShellPDE


def _op_storage():
    """The fine operator basis's storage from FEMO_OP_STORAGE (read at
    model construction): unset or "f64" native f64, "f32" an f32 basis.
    The JAX package's float-float "df" is a TPU storage, not ported."""
    sto = os.environ.get("FEMO_OP_STORAGE")
    if sto in (None, "f64"):
        return None
    if sto == "df":
        raise _not_ported("FEMO_OP_STORAGE=df (the TPU's float-float "
                          "operator storage)")
    if sto != "f32":
        raise ValueError(f"FEMO_OP_STORAGE={sto!r} (f64, f32)")
    return sto


def _not_ported(what):
    return NotImplementedError(
        f"RMShellModel: {what} is not ported to femo_alpha_tpu_torch: the "
        "port replaces it (see ROADMAP.md, \"Replace, do not port\")")


class AggregatedStressModel:
    """aggregated = (1/m) * pnorm^(1/rho)."""

    def __init__(self, m: float, rho: int):
        self.m, self.rho = m, rho

    def evaluate(self, pnorm_stress):
        return 1.0 / self.m * pnorm_stress ** (1.0 / self.rho)


class DisplacementExtractionModel:
    """Mixed solution -> (n_nodes, 3) nodal displacements in the
    caller's node order."""

    def __init__(self, shell_pde: RMShellPDE):
        self.shell_pde = shell_pde

    def evaluate(self, disp_vec):
        mat = self.shell_pde.extract_nodal_disp(disp_vec)
        igi = self.shell_pde.mesh.input_global_indices
        if igi is not None:
            rev = np.argsort(np.asarray(igi))
            mat = mat[torch.as_tensor(rev, device=mat.device)]
        return mat


class ForceReshapingModel:
    """(n_nodes, 3) nodal force matrix in the caller's node order -> the
    interleaved VF dof vector in the FE order."""

    def __init__(self, shell_pde: RMShellPDE):
        self.shell_pde = shell_pde

    def evaluate(self, nodal_force_mat):
        igi = self.shell_pde.mesh.input_global_indices
        mat = torch.as_tensor(nodal_force_mat, dtype=torch.float64,
                              device=self.shell_pde.device)
        if igi is not None:
            mat = mat[torch.as_tensor(np.asarray(igi, dtype=np.int64),
                                      device=mat.device)]
        return mat.reshape(-1)


class RMShellModel:
    def __init__(self, mesh, shell_bc_func=None, element_wise_material=False,
                 rho=100, PENALTY_BC=True, additional_outputs=None,
                 mesh_tags=None, record=False, elementwise_pressure=False,
                 element_type="CG2CG1", solver_opts=None, inplane_deg=4,
                 shear_deg=4, composite_clt=None, device=None,
                 dtype=torch.float64, mg_opts=None):
        if shell_bc_func is None:
            raise ValueError(
                "Please provide the shell bc location function.\n"
                "Example: def ClampedBoundary(x): return x[:, 1] < 0.0")
        if dtype != torch.float64:
            raise _not_ported(f"dtype={dtype} (the solve runs in f64)")
        self.mesh = mesh
        self.mesh_tags = mesh_tags
        self.record = record
        self.solver_opts = solver_opts
        self.mg_opts = dict(mg_opts or {})
        self.shell_bc_func = shell_bc_func
        self.element_wise_material = element_wise_material
        self.m, self.rho = 1e-6, rho
        self.PENALTY_BC = PENALTY_BC
        self.elementwise_pressure = elementwise_pressure
        self.element_type = element_type
        self.inplane_deg, self.shear_deg = inplane_deg, shear_deg
        self.composite_clt = composite_clt
        self.nel = mesh.n_cells
        self.nn = mesh.n_nodes
        self.device = resolve_device(device)
        self.dtype = dtype
        self.subdomain_masks = {}
        self.association_table = {}
        self._modal_m = None           # see _modal_mass
        self._modal_modes_cache = {}   # design point -> modes
        self._force_to_pressure = None  # see evaluate(is_pressure=False)
        if mesh_tags is not None:
            self.set_up_subdomains(mesh_tags)
        self.set_up_fea()

    # ----------------------------------------------------------- subdomains
    def set_up_subdomains(self, mesh_tags):
        """mesh_tags: {tag: [cell indices]} in the CALLER's cell order;
        converted to per-cell masks in the FE order."""
        oci = self.mesh.original_cell_index
        ext2fe = (np.argsort(np.asarray(oci)) if oci is not None
                  else np.arange(self.nel))
        for i, (tag, inds) in enumerate(mesh_tags.items()):
            mask = np.zeros(self.nel)
            mask[ext2fe[np.asarray(inds, dtype=np.int64)]] = 1.0
            self.subdomain_masks[tag] = mask
            self.association_table[tag] = i

    # ------------------------------------------------------------ FEA setup
    def _solver_opts(self, pde, residual_form, facet_forms, bc_dofs):
        """The reference's choice of solver (see the module docstring)."""
        if self.solver_opts is not None:
            return dict(self.solver_opts)
        n = pde.W.n_dofs
        if n <= 6000:
            return {"method": "dense"}
        opts = {"method": "cg", "tol": 1e-11, "maxiter": 20 * int(n ** 0.5)}
        if not self.PENALTY_BC and getattr(self.mesh, "structured", False):
            # FEMO_MG_F32=1: the f32 hierarchy (the JAX package's TPU
            # default, which it lets a user select on the CPU this way)
            sdt = (torch.float32 if os.environ.get("FEMO_MG_F32") == "1"
                   else None)
            mg = build_shell_mg(pde, self.shell_bc_func, dtype=sdt,
                                device=self.device, **self.mg_opts)
            if mg is not None:
                self.mg = mg
                opts["precond_factory"] = ShellMGPrecond(mg, dtype=sdt)
                return opts
        free = None
        if bc_dofs is not None:
            free = np.ones(n)
            free[bc_dofs] = 0.0
        bf = band_precond_factory(pde.W, residual_form, facet_forms,
                                  free_mask=free)
        # the reference's memory guard (FEMO_BAND_MEM_GB, default 6): past
        # it, the nullspace-aggregation AMG + penalty diagonal split
        cap = float(os.environ.get("FEMO_BAND_MEM_GB", "6")) * 1e9
        mem = bf.band.mem_bytes_reference()
        self.band_estimate_gb = mem / 1e9
        if mem > cap:
            opts["precond_factory"] = AMGPrecondFactory(
                pde.W, residual_form, facet_forms, free_mask=free)
            log(f"band precond needs ~{mem / 1e9:.1f}GB (> "
                f"{cap / 1e9:.0f}GB guard); using aggregation-AMG fallback "
                "(expect more iterations than band on thin shells)")
            return opts
        self.band = bf.band
        opts["precond_factory"] = bf
        return opts

    def set_up_fea(self):
        pde = self.shell_pde = RMShellPDE(
            self.mesh, element_wise_material=self.element_wise_material,
            elementwise_pressure=self.elementwise_pressure,
            element_type=self.element_type, inplane_deg=self.inplane_deg,
            shear_deg=self.shear_deg, composite=self.composite_clt,
            device=self.device)
        fea = FEA(self.mesh, dtype=self.dtype, device=self.device)
        residual_form = pde.make_residual_form()
        facet_forms, bc_dofs = [], None
        if self.PENALTY_BC:
            facet_forms.append(pde.make_penalty_facet_form(
                self.shell_bc_func))
        else:
            bc_dofs = strong_bc_dofs(pde, self.shell_bc_func)
        opts = self._solver_opts(pde, residual_form, facet_forms, bc_dofs)
        for name, space in [("thickness", pde.VT), ("F_solid", pde.VF),
                            ("E", pde.VT), ("nu", pde.VT),
                            ("density", pde.VT), ("uhat", pde.VU)]:
            fea.add_input(name, space)

        # the MID-plane isotropic shell stiffness is exactly h*M1 + h^3*M3
        # per cell with element-wise thickness: each linearization
        # re-assembles with one K2 combine; nodal thickness and a laminate
        # are assembled directly. FEMO_OP_STORAGE=f32 rounds that basis to
        # f32 (an f32-accurate operator on the kernels' f32 builds; the JAX
        # package records that this can stall its refinement)
        emf = (CachedAffineAssembler(residual_form,
                                     storage=_op_storage())
               if self.element_wise_material and self.composite_clt is None
               else None)
        fea.add_state("disp_solid", residual_form,
                      arguments=["thickness", "F_solid", "E", "nu", "uhat"],
                      solver_opts=opts, element_matrices_fn=emf,
                      facet_forms=facet_forms)
        if bc_dofs is not None:
            fea.add_strong_bc(bc_dofs, 0.0)

        stress_args = ["disp_solid", "thickness", "E", "nu", "uhat"]
        fea.add_output("compliance", form=pde.compliance_form(),
                       arguments=["disp_solid", "thickness", "uhat"])
        fea.add_output("mass", form=pde.mass_form(),
                       arguments=["thickness", "density", "uhat"])
        fea.add_output("volume", form=pde.volume_form(),
                       arguments=["thickness", "uhat"])
        fea.add_output("elastic_energy", form=pde.elastic_energy_form(),
                       arguments=stress_args)
        fea.add_output("pnorm_stress",
                       form=pde.pnorm_stress_form(m=self.m, rho=self.rho),
                       arguments=stress_args)
        if self.subdomain_masks:
            # one unmasked form shared by every tag; each tag's output
            # assembles over its own cells only
            tag_form = pde.pnorm_stress_form(m=self.m, rho=self.rho)
        for tag, mask in self.subdomain_masks.items():
            cells = np.nonzero(mask > 0.0)[0]

            def fn(vals, cells=cells):
                return assemble_scalar_subset(
                    tag_form, vals["disp_solid"],
                    {k: vals[k] for k in stress_args[1:]}, cells)

            fea.add_output(f"pnorm_stress_{tag}", fn=fn,
                           arguments=stress_args)
        project_vm, _ = pde.von_mises_dg1_projection()

        def stress_fn(vals):
            return project_vm(vals["disp_solid"],
                              {k: vals[k] for k in stress_args[1:]})

        fea.add_field_output("stress", stress_fn, arguments=stress_args)
        self.fea = fea
        self.model = FEAModel(fea=[fea])

    # -------------------------------------------------------------- evaluate
    def _tensor(self, v):
        # the operators and bases live on self.device
        return tensor_on(v, self.device, "RMShellModel", self.dtype)

    def _reorder(self, v, idx):
        """A caller-ordered input in FE order: v[idx] per node or cell (a
        flat per-node vector is reordered node by node)."""
        v = self._tensor(v)
        if idx is None:
            return v.reshape(-1)
        if v.dim() == 1 and v.shape[0] != len(idx):
            v = v.reshape(len(idx), -1)
        return v[torch.as_tensor(np.asarray(idx, dtype=np.int64),
                                 device=self.device)].reshape(-1)

    def _material_index(self):
        """The caller-to-FE index of the material fields: the cell order
        for element-wise fields of a mesh that has one, else the node
        order (as the reference reorders them)."""
        oci = self.mesh.original_cell_index
        if self.element_wise_material and oci is not None:
            return oci
        return self.mesh.input_global_indices

    def _uhat(self, node_disp):
        """node_disp ((n_nodes, 3), or flat node-major) in the caller's
        node order -> uhat (3 n_nodes,) in the FE order; zero for None."""
        if node_disp is None:
            return torch.zeros(3 * self.nn, dtype=self.dtype,
                               device=self.device)
        return self._reorder(node_disp, self.mesh.input_global_indices)

    def fe_inputs(self, force_vector, thickness, E, nu, density=None,
                  node_disp=None):
        """The model's inputs in the FE order, as evaluate hands them to
        the FEA: thickness, E, nu, F_solid, uhat (node_disp, zero without
        it) and, when given, density. Without density the dict is the
        displacement state's parameters (what its ImplicitPDE's residual
        takes)."""
        igi = self.mesh.input_global_indices
        oci = self.mesh.original_cell_index
        mat_idx = self._material_index()
        f_idx = (oci if self.elementwise_pressure and oci is not None
                 else igi)
        inputs = {
            "thickness": self._reorder(thickness, mat_idx),
            "E": self._reorder(E, mat_idx),
            "nu": self._reorder(nu, mat_idx),
            "F_solid": self._reorder(force_vector, f_idx),
            "uhat": self._uhat(node_disp),
        }
        if density is not None:
            inputs["density"] = self._reorder(density, mat_idx)
        return inputs

    def force_to_pressure(self, F):
        """Nodal forces in the FE order -> the pressure field: the solve of
        (VF mass matrix) p = F, differentiable in F (built at first use)."""
        if self._force_to_pressure is None:
            self._force_to_pressure = \
                self.shell_pde.make_force_to_pressure_solver()
        return self._force_to_pressure(F)

    def evaluate(self, force_vector, thickness, E, nu, density,
                 node_disp=None, is_pressure=True):
        """Inputs as tensors or arrays in the CALLER's node/cell order;
        node_disp (n_nodes, 3) moves the mesh (None: no motion);
        is_pressure=False reads force_vector as nodal forces. Returns a
        VariableGroup of tensors, differentiable end to end; the outputs
        are computed on first access."""
        pde = self.shell_pde
        inputs = self.fe_inputs(force_vector, thickness, E, nu, density,
                                node_disp)
        if not is_pressure:
            log("Converting forces to pressures ...")
            inputs["F_solid"] = self.force_to_pressure(inputs["F_solid"])
        out = self.model.evaluate(inputs)
        out.add_lazy("disp_extracted",
                     lambda: DisplacementExtractionModel(pde).evaluate(
                         out.disp_solid))
        out.add_lazy("aggregated_stress",
                     lambda: AggregatedStressModel(self.m, self.rho).evaluate(
                         out.pnorm_stress))
        return out

    # ---------------------------------------------------------------- modal
    def evaluate_modal(self, thickness, E, nu, density, n_modes=6,
                       node_disp=None, tol=1e-8, maxiter=200, seed=0,
                       solver="auto"):
        """Natural frequencies and mode shapes: K phi = omega^2 M phi with
        the shell stiffness (drilling and the penalty or strong BCs
        included) and the consistent shell mass (inertia_form with the
        J(uhat) pullback).

        solver: "auto" (dense below ~6k dofs or on the dense solve path,
        LOBPCG above), "dense" or "lobpcg". The dense path reduces the
        assembled K and M to the free dofs and runs
        dense_generalized_eigh. LOBPCG applies K through the solve path's
        fused operator (with its facet block on penalty meshes), M through
        the fused operator on the inertia form's element matrices (affine
        in element-wise thickness with one power: one K2 combine per
        design; assembled directly for nodal thickness), and is
        preconditioned by the solve path's MG V-cycle, band Cholesky or
        dense solve; its start block is
        numpy.random.default_rng(seed).standard_normal((n, k)).

        Inputs in the CALLER's cell order. Returns a VariableGroup:
        `eigenvalues` (k,) and `frequencies` (Hz), the Rayleigh quotients at
        the converged modes, differentiable in the four inputs (eigenvector
        stationarity makes that the exact eigenvalue gradient); `modes`
        (n_dofs, k; M-orthonormal), `modes_extracted` (k, n_nodes, 3),
        `res_norms`, `iterations`, and `eig_fn(thickness, E, nu, density)
        -> (k,)`, the Rayleigh-quotient map at these modes. node_disp
        (n_nodes, 3) moves the mesh as in evaluate, as a fixed geometry:
        the eigenvalues are differentiable in the four inputs only."""
        k = int(n_modes)
        X, res, iters = self._modal_modes(thickness, E, nu, density, k, tol,
                                          maxiter, seed, solver, node_disp)
        X = X.detach()

        def eig_fn(th, E_, nu_, rho_):
            return self._modal_rayleigh(X, th, E_, nu_, rho_, node_disp)

        lam = eig_fn(thickness, E, nu, density)
        freqs = torch.sqrt(torch.clamp(lam, min=0.0)) / (2.0 * np.pi)
        ext = DisplacementExtractionModel(self.shell_pde)
        modes_x = torch.stack([ext.evaluate(X[:, i]) for i in range(k)])
        return VariableGroup(eigenvalues=lam, frequencies=freqs, modes=X,
                             modes_extracted=modes_x, res_norms=res,
                             iterations=iters, eig_fn=eig_fn)

    def _modal_fe_params(self, node_disp=None):
        """fe_params(th, E, nu, rho) -> (residual params, mass params) in
        FE order, with zero load (the residual at u is then exactly
        K(p) u) and the geometry of node_disp (detached); differentiable
        in the four inputs."""
        pde = self.shell_pde
        mat_idx = self._material_index()
        zeros = dict(dtype=self.dtype, device=self.device)
        uhat = self._uhat(node_disp).detach()

        def fe_params(th, E_, nu_, rho_):
            p = {"thickness": self._reorder(th, mat_idx),
                 "E": self._reorder(E_, mat_idx),
                 "nu": self._reorder(nu_, mat_idx),
                 "F_solid": torch.zeros(pde.VF.n_dofs, **zeros),
                 "uhat": uhat}
            mp = {"thickness": p["thickness"],
                  "density": self._reorder(rho_, mat_idx), "uhat": uhat}
            return p, mp

        return fe_params

    def _modal_mass(self):
        """(inertia form with the J(uhat) pullback, (u, mp) -> its
        lane-major element matrices), made at first use: an affine
        assembler in thickness with one power (one K2 combine) for
        element-wise thickness, its direct assembly for nodal thickness.
        Under shard_model the assembler builds and combines this rank's
        cells only (its basis slice, theta's slice)."""
        if self._modal_m is None:
            mform = self.shell_pde.inertia_form(with_uhat=True)
            asm = CachedAffineAssembler(mform, powers=(1,), ignore_keys=())
            self._modal_m = (mform, asm if self.element_wise_material
                             else asm.direct, asm)
        spec = self.fea.states["disp_solid"].pde.shard_spec
        mform, _, asm = self._modal_m
        if spec is not None and asm.cells is None:
            asm.shard(spec.cells_of(mform.space))
        return self._modal_m[:2]

    def _modal_space(self):
        """The space the modal operators run on: the mixed space, or this
        rank's cells of it (a spaces.CellRange) under shard_model."""
        spec = self.fea.states["disp_solid"].pde.shard_spec
        W = self.shell_pde.W
        return W if spec is None else spec.cells_of(W)

    def _modal_modes(self, thickness, E, nu, density, k, tol, maxiter, seed,
                     solver, node_disp=None):
        """The eigensolve at fixed inputs: (modes X (n, k), res_norms,
        iterations), no autograd graph."""
        ipde = self.fea.states["disp_solid"].pde
        W = self._modal_space()
        n = W.n_dofs
        with torch.no_grad():
            p, mp = self._modal_fe_params(node_disp)(thickness, E, nu,
                                                     density)
            p = {key: v.detach() for key, v in p.items()}
            mp = {key: v.detach() for key, v in mp.items()}
            fm = ipde.free_mask
            free_idx = torch.nonzero(fm > 0.0)[:, 0]
            if k > free_idx.numel():
                raise ValueError(f"n_modes={k} exceeds {free_idx.numel()} "
                                 "free dofs")
            # lane-major (nd, nd, nc): one K2, K = 1, on the basis of this
            # geometry (element-wise thickness), or a direct assembly
            Me = self._modal_mass()[1](None, mp)
            u0 = torch.zeros(n, dtype=self.dtype, device=self.device)
            log(f"Modal analysis: {k} modes, {n} dofs ...")
            use_dense = solver == "dense" or (
                solver == "auto" and (
                    n <= 6000 or ipde.solver_opts.get("method") == "dense"))
            if use_dense:
                # K and M assembled dense: under shard_model each from the
                # rank's cells, summed by one all_reduce (the facet blocks
                # of K added after it)
                ops = ipde._assemble_ops(u0, p)
                Kd = dense_from_blocks(list(zip(ops, ipde._op_specs)), n)
                Md = dense_from_blocks([(Me, W)], n)
                ix = free_idx
                _, Phif = dense_generalized_eigh(Kd[ix][:, ix],
                                                 Md[ix][:, ix], k)
                X = torch.zeros((n, k), dtype=self.dtype, device=self.device)
                X[ix] = Phif
                return X, torch.zeros(k, dtype=self.dtype,
                                      device=self.device), 0
            ls = ipde.make_solver(u0, p)
            ones = torch.ones(n, dtype=self.dtype, device=self.device)
            Mmv = make_constrained_matvec_T(Me, W, ones)

            def Kop(v):
                return fm * ls.matvec(v)

            def Mop(v):
                return fm * Mmv(fm * v)

            # the preconditioner: the solve path's MG V-cycle or band
            # apply; on the dense solve path its exact Cholesky solve
            T = ls.M if ls.M is not None else ls.solve

            def Top(v):
                return fm * T(v)

            rng = np.random.default_rng(seed)
            X0 = torch.as_tensor(rng.standard_normal((n, k)),
                                 dtype=self.dtype, device=self.device)
            _, X, res, iters = lobpcg(Kop, Mop, X0, T=Top, tol=tol,
                                      maxiter=maxiter, free_mask=fm)
            if bool(torch.any(res > 10 * tol)):
                log(f"modal: LOBPCG residuals {res.cpu().numpy()} after "
                    f"{iters} iterations (tol {tol})")
            return X, res, iters

    def _modal_rayleigh(self, X, thickness, E, nu, density,
                        node_disp=None):
        """Rayleigh quotients lam_i = phi_i^T K(p) phi_i / phi_i^T M(p)
        phi_i at FIXED modes X, differentiable in the four inputs: the
        numerator by one residual assembly per mode (zero load, facet
        forms included), the denominator as twice the inertia energy.
        Under shard_model each rank assembles its own cells (rank 0 adds
        the facet terms) and one all_reduce sums the numerators and
        denominators; the inputs enter through grad_all_reduce, so that
        their gradient is summed over the ranks once."""
        from ...parallel.product import grad_all_reduce, sum_over_ranks

        ipde = self.fea.states["disp_solid"].pde
        spec = ipde.shard_spec
        mform, _ = self._modal_mass()
        if spec is not None:
            thickness, E, nu, density = (
                grad_all_reduce(self._tensor(v), spec)
                for v in (thickness, E, nu, density))
        p, mp = self._modal_fe_params(node_disp)(thickness, E, nu, density)
        cells = self._modal_space().cells if spec is not None else None
        nums, dens = [], []
        for i in range(X.shape[1]):
            phi = X[:, i]
            if spec is None:
                r = assemble_residual(ipde.form, phi, p)
                for ff in ipde.facet_forms:
                    r = r + ff.assemble_residual(phi, p)
                m = assemble_scalar(mform, phi, mp)
            else:
                r = ipde._rank_residual(phi, p)
                m = mform.cell_values(mform.energy_kernel, phi, mp,
                                      cells=cells).sum()
            nums.append(torch.dot(phi, r))
            dens.append(2.0 * m)
        k = X.shape[1]
        both = sum_over_ranks(torch.stack(nums + dens), spec)
        return both[:k] / both[k:]

    def modal_eigenvalues(self, thickness, E, nu, density, n_modes=6,
                          node_disp=None, **opts):
        """The smallest eigenvalues (omega^2, ascending), differentiable in
        the four inputs: an eigensolve without autograd (evaluate_modal's,
        `opts` passed on) gives the modes, and the returned eigenvalues are
        the Rayleigh quotients at them, so `.backward()` gives the exact
        eigenvalue gradient. The modes are memoized on the design point
        and node_disp (the last 8): SLSQP asks for the same x several
        times."""
        k = int(n_modes)
        vals = [self._tensor(v) for v in (thickness, E, nu, density)]
        nd = None if node_disp is None else self._tensor(node_disp).detach()
        cache = self._modal_modes_cache
        key = ((k, tuple(sorted(opts.items())),
                None if nd is None else nd.cpu().numpy().tobytes())
               + tuple(v.detach().cpu().numpy().tobytes() for v in vals))
        X = cache.get(key)
        if X is None:
            o = dict(tol=1e-8, maxiter=200, seed=0, solver="auto")
            o.update(opts)
            X = self._modal_modes(*[v.detach() for v in vals], k, **o,
                                  node_disp=nd)[0]
            if len(cache) >= 8:
                cache.pop(next(iter(cache)))
            cache[key] = X
        return self._modal_rayleigh(X, *vals, node_disp=nd)
