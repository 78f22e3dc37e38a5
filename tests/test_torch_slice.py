"""The RM-shell slice end to end: RMShellModel 64x16, strong clamped BC,
element-wise material, MG-preconditioned CG, evaluate + compliance
backward — the port on the CPU against the live JAX package (f64, cells
layout, FEMO_* solver flags unset), and against the committed multi-chip
anchors (compliance 4.387247e-03, |grad| 9.961774e-04)."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import jax
import jax.numpy as jnp

from femo_alpha_tpu.mesh import createRectangleMesh as ref_rect
from femo_alpha_tpu.models import RMShellModel as RefModel

from femo_alpha_tpu_torch.assembly.assemble import assemble_scalar
from femo_alpha_tpu_torch.mesh import createRectangleMesh
from femo_alpha_tpu_torch.models import RMShellModel

NX, NY = 64, 16
REF_FLAGS = ("FEMO_MG_F32", "FEMO_LANE_MAJOR", "FEMO_HOSTLOOP", "FEMO_CG_DF",
             "FEMO_OP_STORAGE")


def _bc(x):
    return x[:, 0] < 1e-12


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _inputs(nel, nn):
    f = np.zeros(3 * nn)
    f[2::3] = 2.0
    return (f, np.full(nel, 0.2), np.full(nel, 4.32e8), np.zeros(nel),
            np.full(nel, 100.0))


@pytest.fixture(scope="module")
def reference():
    with pytest.MonkeyPatch.context() as mp:
        for flag in REF_FLAGS:
            mp.delenv(flag, raising=False)
        mesh = ref_rect(NX, NY, (0, 0), (10.0, 2.0), "quad", gdim=3)
        model = RefModel(mesh, shell_bc_func=_bc, element_wise_material=True,
                         PENALTY_BC=False)
        f, th, E, nu, rho = (jnp.asarray(a) for a in
                             _inputs(mesh.n_cells, mesh.n_nodes))

        def J(th_):
            out = model.evaluate(f, th_, E, nu, rho, is_pressure=True)
            return out.compliance, (out.disp_solid, out.mass)

        (val, (u, mass)), g = jax.value_and_grad(J, has_aux=True)(th)
        return dict(J=float(val), u=np.asarray(u), g=np.asarray(g),
                    mass=float(mass))


@pytest.fixture(scope="module")
def port():
    mesh = createRectangleMesh(NX, NY, (0, 0), (10.0, 2.0), "quad", gdim=3)
    model = RMShellModel(mesh, shell_bc_func=_bc, element_wise_material=True,
                         PENALTY_BC=False, device="cpu")
    f, th, E, nu, rho = (torch.as_tensor(a, dtype=torch.float64) for a in
                         _inputs(mesh.n_cells, mesh.n_nodes))
    th.requires_grad_(True)
    out = model.evaluate(f, th, E, nu, rho)
    out.compliance.backward()
    pde = model.fea.states["disp_solid"].pde
    params = {"thickness": th.detach(), "E": E, "nu": nu, "F_solid": f,
              "uhat": torch.zeros(3 * mesh.n_nodes, dtype=torch.float64)}
    return dict(model=model, pde=pde, params=params,
                J=float(out.compliance.detach()),
                u=out.disp_solid.detach(),
                g=th.grad.numpy(), mass=float(out.mass.detach()))


@pytest.fixture(scope="module")
def direct(port):
    """Host f64 direct solve of the port's assembled, constrained system."""
    pde, params = port["pde"], port["params"]
    zero = torch.zeros(pde.n_dofs, dtype=torch.float64)
    with torch.no_grad():
        Ae = pde._assemble_ops(zero, params)[0].permute(2, 0, 1).numpy()
        b = -pde.residual(zero, params).numpy()
    dm, n = pde.form.space.dofmap, pde.n_dofs
    nd = dm.shape[1]
    K = sp.csr_matrix((Ae.ravel(), (np.repeat(dm, nd, axis=1).ravel(),
                                    np.tile(dm, (1, nd)).ravel())),
                      shape=(n, n))
    free = pde.free_mask.numpy()
    B = (sp.diags(free) @ K @ sp.diags(free) + sp.diags(1.0 - free)).tocsc()
    lu = spla.splu(B)
    u = lu.solve(b)
    return u + lu.solve(b - B @ u)


def _compliance(port, u):
    form = port["model"].fea.outputs["compliance"].form
    p = port["params"]
    return float(assemble_scalar(form, torch.tensor(u),
                                 {"thickness": p["thickness"],
                                  "uhat": p["uhat"]}))


def test_displacement_matches_reference(port, reference):
    assert _rel(port["u"].numpy(), reference["u"]) <= 1e-8


def test_thickness_gradient_matches_reference(port, reference):
    assert _rel(port["g"], reference["g"]) <= 1e-7


def test_compliance_matches_reference(port, reference, direct):
    """Bar 1e-10 relative. The compliance functional meets it on the
    reference's own displacement, and the port's compliance meets it
    against the exact (direct-solve) answer of the discrete system. End to
    end, the two packages' CG solutions each stop at the f64 solve floor,
    so |J_port - J_ref| is held to the bar plus the reference's own
    measured distance from the direct answer."""
    J, Jr = port["J"], reference["J"]
    assert abs(_compliance(port, reference["u"]) - Jr) <= 1e-10 * Jr
    Jd = _compliance(port, direct)
    assert abs(J - Jd) <= 1e-10 * Jd
    assert abs(J - Jr) <= 1e-10 * Jr + abs(Jr - Jd)


def test_displacement_matches_direct_solve(port, direct):
    assert _rel(port["u"].numpy(), direct) <= 1e-8


def test_mass_matches_reference(port, reference):
    # mass = mean(thickness) * area * density = 0.2 * 20 * 100
    assert abs(port["mass"] - reference["mass"]) <= 1e-12 * reference["mass"]
    assert abs(port["mass"] - 400.0) <= 1e-12 * 400.0


def test_multichip_anchors(port):
    assert f"{port['J']:.6e}" == "4.387247e-03"
    assert f"{np.linalg.norm(port['g']):.6e}" == "9.961774e-04"


def test_input_on_another_device_raises(port):
    """A model built on the CPU refuses an input that lies elsewhere (here
    the meta device) instead of moving it."""
    model, p = port["model"], port["params"]
    th = torch.full_like(p["thickness"], 0.2, device="meta")
    with pytest.raises(ValueError, match="device="):
        model.evaluate(p["F_solid"], th, p["E"], p["nu"],
                       torch.full_like(p["E"], 100.0))


def test_solve_quality(port):
    """rel_res within max(1e-8, 2x the residual-measurement floor)."""
    pde, params, u = port["pde"], port["params"], port["u"]
    from femo_alpha_tpu_torch.assembly.assemble import make_matvec_T

    with torch.no_grad():
        zero = torch.zeros_like(u)
        r0 = float(torch.linalg.norm(pde.residual(zero, params)))
        rn = float(torch.linalg.norm(pde.residual(u, params)))
        Ae = pde._assemble_ops(zero, params)[0]
        au = make_matvec_T(Ae.abs(), pde.form.space)(u.abs())
    floor = np.finfo(np.float64).eps * (float(torch.linalg.norm(au)) + r0)
    assert rn / r0 <= max(1e-8, 2.0 * floor / r0)
    info = pde.last_info
    assert info["forward"]["iters"] > 0 and info["adjoint"]["iters"] > 0


def test_gradient_matches_finite_difference(port):
    """Directional central difference of the compliance along a random
    thickness direction against the adjoint gradient (the check the JAX
    package's adjoint/check.py makes)."""
    model, p = port["model"], port["params"]
    d = torch.as_tensor(np.random.default_rng(14).standard_normal(
        p["thickness"].shape[0]))
    eps = 1e-4

    def J(th):
        with torch.no_grad():
            out = model.evaluate(p["F_solid"], th, p["E"], p["nu"],
                                 torch.full_like(th, 100.0))
            return float(out.compliance)

    th0 = p["thickness"]
    fd = (J(th0 + eps * d) - J(th0 - eps * d)) / (2 * eps)
    ad = float(np.dot(port["g"], d.numpy()))
    assert abs(fd - ad) <= 1e-5 * abs(ad)
