"""Reissner-Mindlin shell PDE: energy kernels and output forms.

Port of femo_alpha_tpu/models/rm_shell/pde.py: a mixed displacement x
rotation space (vec3 x vec3) of one of three element pairs, `element_type`
"CG2CG1" (the default; P2 x P1), "CG2CR1" (P2 x Crouzeix-Raviart, triangles
only; the rotations live on the edge midpoints) or "CG1CG1" (P1 x P1; full
integration locks in shear, `shear_deg=1` with `inplane_deg=2` does not):

- energy = membrane + bending + shear + drilling - load work; the residual
  is torch.func.grad of the cell energy
- shape derivatives flow through the mesh-motion field uhat: gradients are
  pulled back by inv(I + grad uhat) and measures carry det(I + grad uhat);
  shear/drilling/load/outputs carry J, membrane+bending do not (parity
  with the reference's measure placement)

- penalty Dirichlet BC: beta/h_E * ||J F^{-T} N|| * |w - g|^2 facet energy
  with beta = 1e15, on exterior and tagged interior facets
- stress recovery: through-thickness displacement u(xi2) = u_mid -
  xi2 (E2 x theta), plane-stress von Mises without transverse shear; its
  p-norm functional and its DG1 projection
- the transient shell's forms: inertia 0.5 rho h (|u|^2 + h_m^2 |theta|^2)
  and the self-weight load

- the force-to-pressure map: a differentiable solve of (VF mass matrix)
  p = F (`make_force_to_pressure_solver`)

Material fields are element-wise (DG0) or nodal (CG1, the reference's
default); the compliance's thickness regularization is L2 for the first
and H1 for the second. The isotropic single-layer CLT sits on the MID
reference plane or, with bot_plane=True, on the BOT plane (B = -h^2/2 C,
D = h^3/3 C). A composite laminate (material.CompositeCLT: per-cell
A/B/D/A_s in the mesh's FE cell order) replaces the single-layer CLT in
the membrane, bending and shear energy; it reaches the kernels as FemForm
cell constants. Drilling, mass, the stresses and the DG1 projection stay
isotropic in (E, nu, h), as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ...assembly.assemble import FemForm
from ...assembly.facets import FacetForm, select_facets
from ...device import resolve_device
from ...elements import tabulate
from ...elements.quadrature import quadrature_rule
from ...spaces import FunctionSpace, MixedSpace
from .kinematics import (
    cell_diameter,
    cross,
    deformation,
    phys_grad_table,
    surface_geometry,
    sym2,
    voigt2d,
)
from .material import plane_stress_C, single_layer_clt

PENALTY_BETA = 1e15  # the reference's penalty factor


def _interp(space, phi, vals):
    """Pointwise interpolation of a scalar parameter: DG0 -> the cell
    constant; CG1 -> nodal interpolation with the CG1 table."""
    if space.family == "DG" and space.degree == 0:
        return vals[0].expand(phi.shape[0])
    return phi @ vals


def _interp_vec(space, phi, vals, vs=3):
    if space.family == "DG" and space.degree == 0:
        return vals.reshape(1, vs).expand(phi.shape[0], vs)
    return phi @ vals.reshape(-1, vs)


class RMShellPDE:
    """Spaces + kernels for the RM shell (CG2CG1, CG2CR1 or CG1CG1
    elements). device: where the element tables live; None means the CUDA
    card."""

    def __init__(self, mesh, element_wise_material=False,
                 elementwise_pressure=False, element_type="CG2CG1",
                 inplane_deg=4, shear_deg=4, stress_deg=4, bot_plane=False,
                 composite=None, device=None, dtype=None):
        ct = mesh.cell_type
        if element_type == "CG2CG1":
            disp_deg, rot_fam, rot_deg = 2, "P", 1
        elif element_type == "CG2CR1":
            if ct != "triangle":
                raise ValueError("CG2CR1 is triangles-only")
            disp_deg, rot_fam, rot_deg = 2, "CR", 1
        elif element_type == "CG1CG1":
            disp_deg, rot_fam, rot_deg = 1, "P", 1
        else:
            raise ValueError(f"element_type={element_type!r}")
        if composite is not None and composite.A.shape[0] != mesh.n_cells:
            raise ValueError(f"composite laminate has {composite.A.shape[0]} "
                             f"cells, the mesh {mesh.n_cells}")
        if dtype not in (None, torch.float64, torch.float32):
            raise TypeError(f"RMShellPDE: dtype {dtype} (float32/float64)")
        device = self.device = resolve_device(device)
        self.dtype = dtype
        self.mesh = mesh
        self.bot_plane = bot_plane
        self.composite = composite
        self.element_wise_material = element_wise_material
        self.elementwise_pressure = elementwise_pressure
        self.V_disp = FunctionSpace(mesh, "P", disp_deg, value_size=3)
        self.V_rot = FunctionSpace(mesh, rot_fam, rot_deg, value_size=3)
        self.element_type = element_type
        self.rot_fam, self.rot_deg = rot_fam, rot_deg
        self.disp_deg = disp_deg
        self.inplane_deg, self.shear_deg = inplane_deg, shear_deg
        self.stress_deg = stress_deg
        self.W = MixedSpace(self.V_disp, self.V_rot)
        self.VT = FunctionSpace(mesh, "DG" if element_wise_material else "P",
                                0 if element_wise_material else 1)
        self.VF = FunctionSpace(mesh, "DG" if elementwise_pressure else "P",
                                0 if elementwise_pressure else 1,
                                value_size=3)
        self.VU = FunctionSpace(mesh, "P", 1, value_size=3)
        self.nd_disp = self.V_disp.element.ndof
        self.nd_rot = self.V_rot.element.ndof
        self.nv = mesh.conn.shape[1]

        # tables per rule (disp/rot/thickness/force bases tabulated at
        # shared points), made once here: the kernels run inside
        # torch.func transforms, which must not create cached tensors. With
        # dtype=float32 the values are rounded to f32; the kernels read them
        # in their inputs' dtype (`_rule`), the f32 forms (make_residual_form,
        # elastic_energy_form) in f32, any other form in f64 on the same
        # rounded values, as the JAX package's type promotion reads them
        tdt = dtype or torch.float64
        self._rules_by = {torch.float64: {}}
        if tdt != torch.float64:
            self._rules_by[tdt] = {}
        for name, deg in [("inplane", inplane_deg), ("shear", shear_deg),
                          ("stress", stress_deg)]:
            pts, w = quadrature_rule(ct, deg)
            tab_d = tabulate("P", ct, disp_deg, points=pts, weights=w)
            tab_r = tabulate(rot_fam, ct, rot_deg, points=pts, weights=w)
            tab_t = tabulate(self.VT.family, ct, self.VT.degree, points=pts,
                             weights=w)
            tab_f = tabulate(self.VF.family, ct, self.VF.degree, points=pts,
                             weights=w)
            tab_o = tabulate("DG", ct, 1, points=pts, weights=w)
            tabs = dict(d_phi=tab_d.phi, d_dphi=tab_d.dphi,
                        geom_dphi=tab_d.geom_dphi, r_phi=tab_r.phi,
                        r_dphi=tab_r.dphi, t_phi=tab_t.phi,
                        t_dphi=tab_t.dphi, f_phi=tab_f.phi,
                        o_phi=tab_o.phi, w=np.asarray(w))
            for dt, rules in self._rules_by.items():
                rules[name] = {
                    k: torch.as_tensor(v, dtype=tdt, device=device).to(dt)
                    for k, v in tabs.items()}
        self._rules = self._rules_by[torch.float64]
        self.param_specs = {"thickness": self.VT, "E": self.VT,
                            "nu": self.VT, "uhat": self.VU,
                            "F_solid": self.VF}

    # ---------------------------------------------------------------- core
    def _rule(self, name, dtype):
        """The tables of one quadrature rule in `dtype` (f64, or the PDE's
        own dtype)."""
        rules = self._rules_by.get(dtype)
        if rules is None:
            raise TypeError(f"RMShellPDE(dtype={self.dtype}): no {dtype} "
                            "tables (build the PDE with that dtype)")
        return rules[name]

    def _split(self, u_cell):
        nd2, nd1 = self.nd_disp, self.nd_rot
        ud = u_cell[: nd2 * 3].reshape(nd2, 3)
        th = u_cell[nd2 * 3: nd2 * 3 + nd1 * 3].reshape(nd1, 3)
        return ud, th

    def _pointwise(self, rule, u_cell, x_cell, p, need_f=False):
        """Shared per-quadrature-point fields for one rule."""
        R = self._rule(rule, x_cell.dtype)
        ud, th = self._split(u_cell)
        uhat = p["uhat"].reshape(self.nv, 3)
        geo = surface_geometry(x_cell, R["geom_dphi"])
        dphi_d = phys_grad_table(R["d_dphi"], geo["Pi"])  # (nq, nd2, 3)
        dphi_r = phys_grad_table(R["r_dphi"], geo["Pi"])
        dphi_g = phys_grad_table(R["geom_dphi"], geo["Pi"])
        F, Finv, detF = deformation(uhat, dphi_g)
        Gu = torch.einsum("ai,qag->qig", ud, dphi_d)
        gradx_u = torch.einsum("qig,qgh->qih", Gu, Finv)
        Gth = torch.einsum("ai,qag->qig", th, dphi_r)
        gradx_th = torch.einsum("qig,qgh->qih", Gth, Finv)
        th_q = R["r_phi"] @ th  # (nq, 3)
        u_q = R["d_phi"] @ ud
        T = torch.stack([geo["E0"], geo["E1"]], dim=1)  # (nq, 2, 3)
        out = dict(
            geo=geo, detF=detF, Finv=Finv, T=T, E2=geo["E2"],
            gradx_u=gradx_u, gradx_th=gradx_th, th_q=th_q, u_q=u_q,
            tq=_interp(self.VT, R["t_phi"], p["thickness"]),
            Eq=_interp(self.VT, R["t_phi"], p["E"]),
            nuq=_interp(self.VT, R["t_phi"], p["nu"]),
            w=R["w"], dA=geo["dA"],
        )
        if need_f:
            out["f_q"] = _interp_vec(self.VF, R["f_phi"], p["F_solid"])
        return out

    def _clt(self, pt, p):
        """(A, B, D, A_s) at the rule's quadrature points: the per-cell
        composite arrays broadcast over the points, or the isotropic
        single-layer CLT."""
        if self.composite is not None:
            nq = pt["tq"].shape[0]
            return (p["clt_A"].expand(nq, 3, 3), p["clt_B"].expand(nq, 3, 3),
                    p["clt_D"].expand(nq, 3, 3),
                    p["clt_As"].expand(nq, 2, 2))
        return single_layer_clt(pt["Eq"], pt["nuq"], pt["tq"],
                                bot=self.bot_plane)

    def _cell_consts(self):
        """The laminate as FemForm cell constants on the PDE's device (made
        per form, outside every transform), or None."""
        if self.composite is None:
            return None
        c = self.composite
        return {k: torch.as_tensor(v, dtype=torch.float64,
                                   device=self.device)
                for k, v in (("clt_A", c.A), ("clt_B", c.B), ("clt_D", c.D),
                             ("clt_As", c.As))}

    @staticmethod
    def _strains(pt):
        """(eps, kappa, gamma, t_gu) in the local frame."""
        T, E2 = pt["T"], pt["E2"]
        gradx_u, gradx_th, th_q = pt["gradx_u"], pt["gradx_th"], pt["th_q"]
        t_gu = torch.einsum("qik,qkl,qjl->qij", T, gradx_u, T)
        # grad(E2 x theta) ~ E2 x grad(theta) column-wise
        gradphi = cross(E2[:, :, None], gradx_th, dim=1)
        kappa = sym2(torch.einsum("qik,qkl,qjl->qij", T, gradphi, T))
        eps = sym2(t_gu)
        # transverse shear gamma[i] = (T(-E2 x th))_i + (T (gradx_u^T E2))_i
        du2 = -cross(E2, th_q)
        g1 = torch.einsum("qij,qj->qi", T, du2)
        g2 = torch.einsum("qij,qj->qi", T,
                          torch.einsum("qk,qkj->qj", E2, gradx_u))
        return eps, kappa, g1 + g2, t_gu

    # ------------------------------------------------------------- energies
    def make_elastic_energy_kernel(self, with_load=True, with_drilling=True):
        """Cell energy kernel (inplane + shear + drilling [- load])."""

        def energy(u_cell, x_cell, p):
            # membrane + bending at the inplane rule (no detF)
            pi = self._pointwise("inplane", u_cell, x_cell, p,
                                 need_f=with_load)
            eps, kappa, _, t_gu = self._strains(pi)
            A, B, D, _ = self._clt(pi, p)
            ev = voigt2d(eps)
            kv = voigt2d(kappa)
            N = torch.einsum("qij,qj->qi", A, ev) + torch.einsum(
                "qij,qj->qi", B, kv)
            M = torch.einsum("qij,qj->qi", B, ev) + torch.einsum(
                "qij,qj->qi", D, kv)
            wdA = pi["w"] * pi["dA"]
            total = torch.sum(0.5 * torch.sum(N * ev + M * kv, dim=1) * wdA)
            if with_drilling:
                # strain = skew(t_gu) + theta.E2, alpha = E h^3 / h_mesh^2
                h_mesh = cell_diameter(x_cell)
                dstrain = 0.5 * (t_gu[:, 0, 1] - t_gu[:, 1, 0]) + torch.sum(
                    pi["th_q"] * pi["E2"], dim=1)
                alpha = pi["Eq"] * pi["tq"] ** 3
                total = total + torch.sum(
                    0.5 * alpha * dstrain ** 2 / h_mesh ** 2 * pi["detF"]
                    * wdA)
            if with_load:
                total = total - torch.sum(
                    torch.sum(pi["f_q"] * pi["u_q"], dim=1) * pi["detF"]
                    * wdA)
            # shear at the shear rule, with detF
            ps = self._pointwise("shear", u_cell, x_cell, p)
            _, _, gamma, _ = self._strains(ps)
            As_s = self._clt(ps, p)[3]
            Q = torch.einsum("qij,qj->qi", As_s, gamma)
            E_sh = torch.sum(0.5 * torch.sum(Q * gamma, dim=1) * ps["detF"]
                             * ps["w"] * ps["dA"])
            return total + E_sh

        return energy

    def make_residual_form(self):
        return FemForm(self.W, self.make_elastic_energy_kernel(),
                       kind="energy", param_specs=dict(self.param_specs),
                       cell_consts=self._cell_consts(), dtype=self.dtype)

    def inertia_form(self, rho_is_param=True, with_uhat=False):
        """Shell inertia as an energy, 0.5 rho h (|u|^2 + h_m^2 |theta|^2)
        with h_m the cell diameter: its Hessian is the mass operator. The
        density is the DG0/CG1 field "density" or, with
        rho_is_param=False, the scalar "rho" (passed to every cell).
        with_uhat: include the J(uhat) deformed-configuration pullback (the
        modal path; the transient shell integrates on the reference
        configuration and leaves it out)."""
        nv = self.nv

        def kern(u_cell, x_cell, p):
            R = self._rule("inplane", x_cell.dtype)
            ud, th = self._split(u_cell)
            geo = surface_geometry(x_cell, R["geom_dphi"])
            u_q = R["d_phi"] @ ud
            th_q = R["r_phi"] @ th
            hq = _interp(self.VT, R["t_phi"], p["thickness"])
            rhoq = (_interp(self.VT, R["t_phi"], p["density"])
                    if rho_is_param else p["rho"])
            hm = cell_diameter(x_cell)
            dens = rhoq * hq * (torch.sum(u_q ** 2, dim=1)
                                + hm ** 2 * torch.sum(th_q ** 2, dim=1))
            if with_uhat:
                dphi_g = phys_grad_table(R["geom_dphi"], geo["Pi"])
                _, _, detF = deformation(p["uhat"].reshape(nv, 3), dphi_g)
                dens = dens * detF
            return torch.sum(0.5 * dens * R["w"] * geo["dA"])

        specs = {"thickness": self.VT}
        if rho_is_param:
            specs["density"] = self.VT
        else:
            specs["rho"] = None
        if with_uhat:
            specs["uhat"] = self.VU
        return FemForm(self.W, kern, kind="energy", param_specs=specs)

    def self_weight_load(self, g_z):
        """Self-weight load energy -int rho h g_z u_z dx: its residual is
        the (negative) load vector."""

        def kern(u_cell, x_cell, p):
            R = self._rule("inplane", x_cell.dtype)
            ud, _ = self._split(u_cell)
            geo = surface_geometry(x_cell, R["geom_dphi"])
            u_q = R["d_phi"] @ ud
            hq = _interp(self.VT, R["t_phi"], p["thickness"])
            rhoq = _interp(self.VT, R["t_phi"], p["density"])
            return -torch.sum(rhoq * hq * g_z * u_q[:, 2] * R["w"]
                              * geo["dA"])

        return FemForm(self.W, kern, kind="energy",
                       param_specs={"thickness": self.VT,
                                    "density": self.VT})

    # ------------------------------------------------------------- outputs
    def regularization_kernel(self, kind):
        """Thickness regularization energy of `kind`: "L2" is
        0.5e-2 int h^2 dx (element-wise thickness), "H1" is
        0.5e-2 int |grad h|^2 dx (nodal thickness), on the reference
        measure."""
        if kind not in ("L2", "H1"):
            raise ValueError(f"regularization_kernel({kind!r})")
        alpha1 = 1e-2

        def kern(u_cell, x_cell, p):
            R = self._rule("inplane", x_cell.dtype)
            geo = surface_geometry(x_cell, R["geom_dphi"])
            wdA = R["w"] * geo["dA"]
            if kind == "L2":
                hq = _interp(self.VT, R["t_phi"], p["thickness"])
                return torch.sum(0.5 * alpha1 * hq ** 2 * wdA)
            dphi_t = phys_grad_table(R["t_dphi"], geo["Pi"])
            gh = torch.einsum("a,qag->qg", p["thickness"], dphi_t)
            return torch.sum(0.5 * alpha1 * torch.sum(gh * gh, dim=1) * wdA)

        return kern

    def compliance_form(self):
        """int |u_mid|^2 J(uhat) dx + the thickness regularization (L2 for
        element-wise thickness, H1 for nodal)."""
        reg = self.regularization_kernel(
            "L2" if self.element_wise_material else "H1")
        nv = self.nv

        def kern(u_cell, x_cell, p):
            R = self._rule("inplane", x_cell.dtype)
            ud, _ = self._split(u_cell)
            geo = surface_geometry(x_cell, R["geom_dphi"])
            dphi_g = phys_grad_table(R["geom_dphi"], geo["Pi"])
            _, _, detF = deformation(p["uhat"].reshape(nv, 3), dphi_g)
            u_q = R["d_phi"] @ ud
            val = torch.sum(torch.sum(u_q ** 2, dim=1) * detF * R["w"]
                            * geo["dA"])
            return val + reg(u_cell, x_cell, p)

        return FemForm(self.W, kern, kind="energy",
                       param_specs={"thickness": self.VT, "uhat": self.VU})

    def mass_form(self):
        """int rho h J(uhat) dx, with the thickness as primary argument."""

        def kern(h_cell, x_cell, p):
            R = self._rule("inplane", x_cell.dtype)
            geo = surface_geometry(x_cell, R["geom_dphi"])
            dphi_g = phys_grad_table(R["geom_dphi"], geo["Pi"])
            _, _, detF = deformation(p["uhat"].reshape(self.nv, 3), dphi_g)
            hq = _interp(self.VT, R["t_phi"], h_cell)
            rhoq = _interp(self.VT, R["t_phi"], p["density"])
            return torch.sum(rhoq * hq * detF * R["w"] * geo["dA"])

        return FemForm(self.VT, kern, kind="energy",
                       param_specs={"density": self.VT, "uhat": self.VU})

    def volume_form(self):
        """int h J(uhat) dx, with the thickness as primary argument."""

        def kern(h_cell, x_cell, p):
            R = self._rule("inplane", x_cell.dtype)
            geo = surface_geometry(x_cell, R["geom_dphi"])
            dphi_g = phys_grad_table(R["geom_dphi"], geo["Pi"])
            _, _, detF = deformation(p["uhat"].reshape(self.nv, 3), dphi_g)
            hq = _interp(self.VT, R["t_phi"], h_cell)
            return torch.sum(hq * detF * R["w"] * geo["dA"])

        return FemForm(self.VT, kern, kind="energy",
                       param_specs={"uhat": self.VU})

    def elastic_energy_form(self):
        """The strain energy (inplane + shear + drilling, no load work)."""
        specs = dict(self.param_specs)
        specs.pop("F_solid")
        return FemForm(self.W,
                       self.make_elastic_energy_kernel(with_load=False),
                       kind="energy", param_specs=specs,
                       cell_consts=self._cell_consts(), dtype=self.dtype)

    # ------------------------------------------------------------ penalty BC
    def make_penalty_facet_form(self, bc_locs_func, quad_degree=4,
                                include_interior=True):
        """Penalty Dirichlet facet energy (g = 0, beta = 1e15, Nanson-
        transformed measure) on the exterior facets whose midpoints satisfy
        bc_locs_func, once each, and on the interior facets all of whose
        vertices do, once per incident cell (C0 shared dofs make that the
        ('+') + ('-') pair, and non-manifold junction edges penalize all
        their incidences)."""
        cells, locals_ = select_facets(self.mesh, bc_locs_func)
        if include_interior:
            icells, ilocals = self.mesh.interior_facets(bc_locs_func)
            cells = np.concatenate([np.asarray(cells), icells])
            locals_ = np.concatenate([np.asarray(locals_), ilocals])
        fam_d, fam_r = ("P", self.disp_deg), (self.rot_fam, self.rot_deg)
        families = [fam_d, fam_r]
        nd2, nd1, nv = self.nd_disp, self.nd_rot, self.nv
        dev = self.device

        def factory(tabs):
            t64 = dict(dtype=torch.float64, device=dev)
            phi_d = torch.as_tensor(tabs.tabs[fam_d][0], **t64)
            phi_r = torch.as_tensor(tabs.tabs[fam_r][0], **t64)
            geom_dphi = torch.as_tensor(tabs.geom_dphi, **t64)
            dxi_dt = torch.as_tensor(tabs.dxi_dt, **t64)
            w1d = torch.as_tensor(tabs.weights, **t64)

            def energy(u_cell, x_cell, p):
                ud = u_cell[: nd2 * 3].reshape(nd2, 3)
                th = u_cell[nd2 * 3:].reshape(nd1, 3)
                uhat = p["uhat"].reshape(nv, 3)
                geo = surface_geometry(x_cell, geom_dphi)
                dphi_g = phys_grad_table(geom_dphi, geo["Pi"])
                _, Finv, detF = deformation(uhat, dphi_g)
                tvec = torch.einsum("qgr,r->qg", geo["Jg"], dxi_dt)
                tlen = torch.sqrt(torch.sum(tvec * tvec, dim=1))
                that = tvec / tlen[:, None]
                # in-plane facet normal (its orientation does not matter)
                N = cross(that, geo["E2"])
                # Nanson: n da = J F^{-T} N dA
                v = detF[:, None] * torch.einsum("qgh,qg->qh", Finv, N)
                normN = torch.sqrt(torch.sum(v * v, dim=1))
                u_q = phi_d @ ud
                th_q = phi_r @ th
                h_E = cell_diameter(x_cell)
                mag2 = torch.sum(u_q ** 2, dim=1) + torch.sum(th_q ** 2,
                                                              dim=1)
                return torch.sum(
                    0.5 * PENALTY_BETA / h_E * normN * mag2 * tlen * w1d)

            return energy

        return FacetForm(self.W, factory, cells, locals_,
                         param_specs={"uhat": self.VU},
                         quad_degree=quad_degree, families=families)

    # --------------------------------------------------------------- stress
    @staticmethod
    def _vm_stress_at_q(pt, xi2):
        """Plane-stress von Mises at the through-thickness coordinate xi2
        (transverse shear excluded)."""
        T, E2 = pt["T"], pt["E2"]
        # grad u(xi2) = gradx_u - xi2 * (E2 x gradx_th)
        gradphi = cross(E2[:, :, None], pt["gradx_th"], dim=1)
        grad_u_xi2 = pt["gradx_u"] - xi2[:, None, None] * gradphi
        loc = torch.einsum("qik,qkl,qjl->qij", T, grad_u_xi2, T)
        eps = voigt2d(sym2(loc))
        C = plane_stress_C(pt["Eq"], pt["nuq"])
        sig = torch.einsum("qij,qj->qi", C, eps)
        vm2 = (sig[:, 0] ** 2 - sig[:, 0] * sig[:, 1] + sig[:, 1] ** 2
               + 3.0 * sig[:, 2] ** 2)
        return torch.sqrt(torch.clamp(vm2, min=1e-300))

    def pnorm_stress_form(self, m=1e-6, rho=100, alpha=None, surface="Top",
                          cell_mask=None):
        """int (m sigma_vM)^rho J dx / alpha at the stress rule, in f64
        ((m sigma)^rho reaches ~1e263 at aircraft loads). alpha defaults to
        the reference (uhat = 0) surface area, a constant. With cell_mask
        (n_cells,), each cell energy is scaled by its entry, passed as the
        parameter "_mask" (the values are kept on the form as
        `_mask_values`)."""
        if alpha is None:
            alpha = self.surface_area()
        sgn = {"Top": 0.5, "Mid": 0.0, "Bot": -0.5}[surface]

        def kern(u_cell, x_cell, p):
            pt = self._pointwise("stress", u_cell, x_cell, p)
            vm = self._vm_stress_at_q(pt, sgn * pt["tq"])
            val = torch.sum((m * vm) ** rho * pt["detF"] * pt["w"]
                            * pt["dA"])
            return val / alpha

        specs = dict(self.param_specs)
        specs.pop("F_solid")
        if cell_mask is None:
            return FemForm(self.W, kern, kind="energy", param_specs=specs)

        def kern_masked(u_cell, x_cell, p):
            return kern(u_cell, x_cell, p) * p["_mask"][0]

        specs["_mask"] = FunctionSpace(self.mesh, "DG", 0)
        form = FemForm(self.W, kern_masked, kind="energy", param_specs=specs)
        form._mask_values = torch.as_tensor(
            np.asarray(cell_mask, dtype=np.float64), device=self.device)
        return form

    def surface_area(self):
        """Reference (uhat = 0) total surface area: the alpha constant."""
        R = self._rules["inplane"]
        x = torch.as_tensor(self.mesh.cell_coords(), dtype=torch.float64,
                            device=self.device)

        def cell_area(xc):
            geo = surface_geometry(xc, R["geom_dphi"])
            return torch.sum(R["w"] * geo["dA"])

        return float(torch.sum(torch.func.vmap(cell_area)(x)))

    def von_mises_dg1_projection(self):
        """Field output: the von Mises stress (Top) L2-projected into DG1,
        one local mass solve per cell (a batched f64 Cholesky). Returns
        (project(u, params) -> DG1 dof vector (cell-major), V_out)."""
        V_out = FunctionSpace(self.mesh, "DG", 1)
        specs = dict(self.param_specs)
        specs.pop("F_solid")

        def cell_fn(u_cell, x_cell, p):
            pt = self._pointwise("stress", u_cell, x_cell, p)
            vm = self._vm_stress_at_q(pt, 0.5 * pt["tq"])
            phi_o = self._rule("stress", x_cell.dtype)["o_phi"]
            wdA = pt["w"] * pt["dA"]
            Mloc = torch.einsum("qa,qb,q->ab", phi_o, phi_o, wdA)
            b = torch.einsum("qa,q,q->a", phi_o, vm, wdA)
            return Mloc, b

        form = FemForm(self.W, cell_fn, kind="residual", param_specs=specs)

        def project(u, params):
            Mloc, b = form.cell_values(form.kernel, u, params)
            L, info = torch.linalg.cholesky_ex(Mloc)
            if bool(info.any()):
                raise RuntimeError("von_mises_dg1_projection: a cell mass "
                                   "matrix is not positive definite")
            return torch.cholesky_solve(b[..., None], L)[..., 0].reshape(-1)

        return project, V_out

    def make_force_to_pressure_solver(self):
        """solve_pressure(F) -> p: the differentiable solve of (VF mass
        matrix) p = F, for F in the FE order. Point-Jacobi CG at tol 1e-12
        (the LinearSolver's default preconditioner, which the JAX package's
        {"method": "cg", "tol": 1e-12} also selects), whose every
        application is the fused operator on the VF mass form's element
        matrices; its backward is one more solve. `solve_pressure.pde` is
        the ImplicitPDE (its last_info holds the CG iterations)."""
        from ...adjoint.implicit import ImplicitPDE

        VF = self.VF
        R = self._rules["inplane"]

        def mass_energy(f_cell, x_cell, p):
            geo = surface_geometry(x_cell, R["geom_dphi"])
            fq = _interp_vec(VF, R["f_phi"], f_cell)
            return torch.sum(
                0.5 * torch.sum(fq * fq, dim=1) * R["w"] * geo["dA"])

        form = FemForm(VF, mass_energy, kind="energy", param_specs={})
        t64 = dict(dtype=torch.float64, device=self.device)
        pde = ImplicitPDE(
            form, torch.ones(VF.n_dofs, **t64), torch.zeros(VF.n_dofs, **t64),
            solver_opts={"method": "cg", "tol": 1e-12},
            extra_residual=lambda u, p: -p["F_vec"])

        def solve_pressure(F_vec):
            return pde.solve({"F_vec": F_vec})

        solve_pressure.pde = pde
        return solve_pressure

    # -------------------------------------------------------- interop maps
    def extract_nodal_disp(self, w):
        """Nodal displacements (n_nodes, 3): the value of a Lagrange (P1 or
        P2) field at a mesh vertex is its vertex dof, and vertex dofs come
        first in the dofmap."""
        nn = self.mesh.n_nodes
        return w[: 3 * nn].reshape(nn, 3)
