"""fea/utils.py, assembly/geometry.py and spaces.Function of the port on the
CPU, against the JAX package's functions: the point and vertex helpers of
tests/test_fea_api.py::test_point_and_vertex_utils (getCellID,
getVertexToDofMap, applyNodalForces, projectPointForce), errorNorm,
project (lumped and consistent), move, calculateSurfaceArea,
Function.interpolate and map_gradients.

Inputs are made with numpy from a seed and handed to both packages; f64
throughout. Tolerances: 1e-13 relative for closed-form results (the same
arithmetic in another order), 1e-10 for the CG mass solves (both packages
stop at a relative residual of 1e-12 on a mass matrix whose condition
number is below a hundred), and exact equality for integer maps and
copies."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from femo_alpha_tpu.assembly.assemble import make_matvec as ref_matvec
from femo_alpha_tpu.assembly.geometry import map_gradients as ref_map_grad
from femo_alpha_tpu.fea import utils as ref
from femo_alpha_tpu.mesh import createRectangleMesh as ref_rect
from femo_alpha_tpu.mesh import createWingShellMesh as ref_wing
from femo_alpha_tpu.spaces import FunctionSpace as RefFS
from femo_alpha_tpu.spaces import MixedSpace as RefMS

from femo_alpha_tpu_torch.assembly.geometry import map_gradients
from femo_alpha_tpu_torch.fea import utils
from femo_alpha_tpu_torch.mesh import createRectangleMesh, createWingShellMesh
from femo_alpha_tpu_torch.spaces import Function, FunctionSpace, MixedSpace

RECT = dict(nx=8, ny=4, p0=(0.0, 0.0), p1=(2.0, 1.0), cell_type="quad",
            structured=False)


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _fn(x):
    return np.sin(x[:, 0]) * np.cos(2.0 * x[:, 1]) + x[:, 0] ** 2


@pytest.fixture(scope="module")
def rect():
    """The unstructured 8x4 quad rectangle of test_fea_api.py in both
    packages, with its P1 spaces."""
    mesh, rmesh = createRectangleMesh(**RECT), ref_rect(**RECT)
    return dict(mesh=mesh, rmesh=rmesh, V=FunctionSpace(mesh, "P", 1),
                RV=RefFS(rmesh, "P", 1))


def test_point_and_vertex_utils(rect):
    """getCellID locates cell midpoints to their own cells;
    getVertexToDofMap and applyNodalForces place vertex forces at the
    displacement vertex dofs of the mixed shell space; both equal the
    JAX package's."""
    mesh, rmesh = rect["mesh"], rect["rmesh"]
    mids = mesh.cell_midpoints()[[0, 5, 17]]
    cells = utils.getCellID(mids, mesh)
    assert list(cells) == [0, 5, 17]
    np.testing.assert_array_equal(cells, ref.getCellID(mids, rmesh))

    W = MixedSpace(FunctionSpace(mesh, "P", 2, value_size=3),
                   FunctionSpace(mesh, "P", 1, value_size=3))
    RW = RefMS(RefFS(rmesh, "P", 2, value_size=3),
               RefFS(rmesh, "P", 1, value_size=3))
    v2d = utils.getVertexToDofMap(W)
    assert v2d.shape == (mesh.n_nodes, 3)
    np.testing.assert_array_equal(v2d, ref.getVertexToDofMap(RW))
    f = np.random.default_rng(0).normal(size=(mesh.n_nodes, 3))
    F = utils.applyNodalForces(f, W, device="cpu")
    assert F.shape == (W.n_dofs,)
    np.testing.assert_array_equal(F.numpy(),
                                  np.asarray(ref.applyNodalForces(f, RW)))
    mask = np.ones(W.n_dofs, bool)
    mask[v2d.reshape(-1)] = False
    assert np.all(F.numpy()[mask] == 0.0)


def test_project_point_force_matches_reference(rect):
    """The Riesz map of M u recovers u (scalar and vector P1), and equals
    the JAX package's on the same dual vectors."""
    V, RV = rect["V"], rect["RV"]
    rng = np.random.default_rng(1)
    u = rng.normal(size=V.n_dofs)
    # M u by the JAX package's consistent P1 mass (as test_fea_api.py)
    rtab = RV.tabulate(quad_degree=4)
    phi = jnp.asarray(rtab.phi)

    def cell_mass(xc):
        _, wdet = ref_map_grad(xc, rtab)
        return jnp.einsum("qa,qb,q->ab", phi, phi, wdet)

    mv = ref_matvec(jax.vmap(cell_mass)(RV.cell_coords_d), RV)
    b = np.asarray(mv(jnp.asarray(u)))
    got = utils.projectPointForce(V, b, device="cpu")
    np.testing.assert_allclose(got.numpy(), u, atol=1e-9)
    assert _rel(got, ref.projectPointForce(RV, b)) <= 1e-10
    V3 = FunctionSpace(rect["mesh"], "P", 1, value_size=3)
    u3 = rng.normal(size=(V.n_dofs, 3))
    f3 = np.stack([np.asarray(mv(jnp.asarray(u3[:, c]))) for c in range(3)],
                  axis=1).reshape(-1)
    got3 = utils.projectPointForce(V3, torch.tensor(f3))
    np.testing.assert_allclose(got3.numpy(), u3.reshape(-1), atol=1e-9)


@pytest.mark.parametrize("lump_mass", [False, True])
def test_project_matches_reference(rect, lump_mass):
    """L2 projection of a coordinate function into P1 and P2, consistent
    (CG mass solve) and lumped."""
    mesh, rmesh = rect["mesh"], rect["rmesh"]
    bar = 1e-13 if lump_mass else 1e-10
    for deg in (1, 2):
        got = utils.project(FunctionSpace(mesh, "P", deg), _fn,
                            lump_mass=lump_mass, device="cpu")
        want = ref.project(RefFS(rmesh, "P", deg), _fn, lump_mass=lump_mass)
        assert _rel(got, want) <= bar, deg


def test_error_norm_matches_reference(rect):
    """||u_h - u_exact||_L2 of a seeded P1 field."""
    u = np.random.default_rng(2).normal(size=rect["V"].n_dofs)
    got = utils.errorNorm(rect["V"], torch.tensor(u), _fn)
    want = ref.errorNorm(rect["RV"], jnp.asarray(u), _fn)
    assert abs(got / want - 1.0) <= 1e-13


def test_move_and_surface_area_match_reference():
    """move() shifts the coordinates; calculateSurfaceArea of a moved
    generated wing equals the JAX package's."""
    kw = dict(n_chord=4, n_span=6, rib_stations=(3,))
    mesh, rmesh = createWingShellMesh(**kw), ref_wing(**kw)
    disp = 0.01 * np.random.default_rng(3).normal(size=(mesh.n_nodes, 3))
    moved, rmoved = utils.move(mesh, torch.tensor(disp)), ref.move(rmesh,
                                                                   disp)
    np.testing.assert_array_equal(moved.coords, np.asarray(rmoved.coords))
    np.testing.assert_array_equal(moved.conn, np.asarray(rmoved.conn))
    for m, rm in ((mesh, rmesh), (moved, rmoved)):
        got = utils.calculateSurfaceArea(m, device="cpu")
        assert abs(got / ref.calculateSurfaceArea(rm) - 1.0) <= 1e-13


def test_function_interpolate_matches_reference(rect):
    """Function.interpolate at the dof coordinates of P2 and vector P1
    spaces; copy() keeps the values."""
    from femo_alpha_tpu.spaces.space import Function as RefFunction

    mesh, rmesh = rect["mesh"], rect["rmesh"]
    for deg, vs in ((2, 1), (1, 3)):
        def fn(x, vs=vs):
            v = _fn(x)
            return v if vs == 1 else np.stack([v, 2 * v, -v], axis=1)

        f = Function(FunctionSpace(mesh, "P", deg, value_size=vs),
                     device="cpu").interpolate(fn)
        rf = RefFunction(RefFS(rmesh, "P", deg, value_size=vs)) \
            .interpolate(fn)
        np.testing.assert_array_equal(f.x.numpy(), np.asarray(rf.x))
        assert torch.equal(f.copy().x, f.x)


def test_map_gradients_matches_reference():
    """Physical gradients and measures of every cell, P2 on quads and
    triangles."""
    from femo_alpha_tpu_torch.elements import tabulate

    for cell_type in ("quad", "triangle"):
        kw = dict(RECT, cell_type=cell_type)
        mesh = createRectangleMesh(**kw)
        x = mesh.cell_coords() + 0.01 * np.random.default_rng(4).normal(
            size=mesh.cell_coords().shape)
        tab = tabulate("P", cell_type, 2, quad_degree=4)
        got = torch.func.vmap(lambda xc: map_gradients(xc, tab))(
            torch.tensor(x))
        want = jax.vmap(lambda xc: ref_map_grad(xc, tab))(jnp.asarray(x))
        for a, b in zip(got, want):
            assert _rel(a, b) <= 1e-13, cell_type
