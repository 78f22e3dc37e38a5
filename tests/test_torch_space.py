"""Port parity of the host-side layers and the function spaces: mesh
arrays, element tables and dofmaps are identical to femo_alpha_tpu's; the
structured (slice) and generic (indexed) gather/scatter match the
reference; every scatter is the exact adjoint of its gather
(<G x, y> = <x, G^T y>) for P1, P2 and DG0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from femo_alpha_tpu.elements import tabulate as ref_tabulate
from femo_alpha_tpu.mesh import createRectangleMesh as ref_rect
from femo_alpha_tpu.spaces import FunctionSpace as RefSpace
from femo_alpha_tpu.spaces import locate_dofs_geometric as ref_locate

from femo_alpha_tpu_torch.elements import tabulate
from femo_alpha_tpu_torch.mesh import createRectangleMesh
from femo_alpha_tpu_torch.spaces import (
    FunctionSpace,
    MixedSpace,
    locate_dofs_geometric,
)

NX, NY = 6, 3
SPACES = [("P", 1, 3), ("P", 2, 3), ("DG", 0, 1), ("P", 1, 1)]


@pytest.fixture(scope="module", params=["structured", "indexed"])
def meshes(request):
    """Structured plates take the slice gathers, generic meshes the
    indexed ones."""
    s = request.param == "structured"
    return (createRectangleMesh(NX, NY, (0, 0), (10.0, 2.0), "quad", gdim=3,
                                structured=s),
            ref_rect(NX, NY, (0, 0), (10.0, 2.0), "quad", gdim=3,
                     structured=s))


@pytest.mark.parametrize("structured", [True, False])
def test_mesh_arrays_identical(structured):
    m = createRectangleMesh(NX, NY, (0, 0), (10.0, 2.0), "quad", gdim=3,
                            structured=structured)
    r = ref_rect(NX, NY, (0, 0), (10.0, 2.0), "quad", gdim=3,
                 structured=structured)
    np.testing.assert_array_equal(m.coords, r.coords)
    np.testing.assert_array_equal(m.conn, r.conn)
    m._build_topology()
    r._build_topology()
    np.testing.assert_array_equal(m.edges, r.edges)
    np.testing.assert_array_equal(m.cell_edges, r.cell_edges)
    np.testing.assert_array_equal(m.ext_facet_cell, r.ext_facet_cell)
    np.testing.assert_array_equal(m.ext_facet_verts, r.ext_facet_verts)


@pytest.mark.parametrize("family,degree", [("P", 1), ("P", 2), ("DG", 0)])
def test_tabulation_identical(family, degree):
    a = tabulate(family, "quad", degree, quad_degree=4)
    b = ref_tabulate(family, "quad", degree, quad_degree=4)
    for name in ("points", "weights", "phi", "dphi", "geom_phi", "geom_dphi"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("family,degree,vs", SPACES)
def test_dofmaps_and_coords_identical(meshes, family, degree, vs):
    m, r = meshes
    s, rs = FunctionSpace(m, family, degree, vs), RefSpace(r, family, degree,
                                                            vs)
    assert s.n_dofs == rs.n_dofs
    np.testing.assert_array_equal(s.dofmap, rs.dofmap)
    np.testing.assert_array_equal(s.dof_coords, rs.dof_coords)
    pred = lambda x: x[:, 0] < 1e-12  # noqa: E731
    np.testing.assert_array_equal(locate_dofs_geometric(s, pred),
                                  ref_locate(rs, pred))


@pytest.mark.parametrize("family,degree,vs", SPACES)
def test_gather_scatter_match_reference(meshes, family, degree, vs):
    m, r = meshes
    s, rs = FunctionSpace(m, family, degree, vs), RefSpace(r, family, degree,
                                                            vs)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(s.n_dofs)
    cT = rng.standard_normal((s.nd_local, m.n_cells))
    xt, ct = torch.as_tensor(x), torch.as_tensor(cT)
    np.testing.assert_allclose(s.gather_T(xt).numpy(),
                               np.asarray(rs.gather_T(jnp.asarray(x))),
                               rtol=0, atol=0)
    np.testing.assert_allclose(s.gather(xt).numpy(),
                               np.asarray(rs.gather(jnp.asarray(x))),
                               rtol=0, atol=0)
    np.testing.assert_allclose(s.scatter_add_T(ct).numpy(),
                               np.asarray(rs.scatter_add_T(jnp.asarray(cT))),
                               rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(s.scatter_add(ct.T).numpy(),
                               np.asarray(rs.scatter_add(jnp.asarray(cT.T))),
                               rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("family,degree,vs", SPACES)
def test_scatter_is_adjoint_of_gather(meshes, family, degree, vs):
    s = FunctionSpace(meshes[0], family, degree, vs)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal(s.n_dofs))
    y = torch.as_tensor(rng.standard_normal((s.nd_local, s.mesh.n_cells)))
    lhs = float(torch.sum(s.gather_T(x) * y))
    rhs = float(torch.dot(x, s.scatter_add_T(y)))
    assert abs(lhs - rhs) <= 1e-13 * max(abs(lhs), 1.0)
    lhs = float(torch.sum(s.gather(x) * y.T))
    rhs = float(torch.dot(x, s.scatter_add(y.T)))
    assert abs(lhs - rhs) <= 1e-13 * max(abs(lhs), 1.0)


def test_mixed_space_lane_major_matches_reference(meshes):
    from femo_alpha_tpu.spaces import MixedSpace as RefMixed

    m, r = meshes
    W = MixedSpace(FunctionSpace(m, "P", 2, 3), FunctionSpace(m, "P", 1, 3))
    RW = RefMixed(RefSpace(r, "P", 2, 3), RefSpace(r, "P", 1, 3))
    np.testing.assert_array_equal(W.dofmap, RW.dofmap)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(W.n_dofs)
    cT = rng.standard_normal((W.nd_local, m.n_cells))
    np.testing.assert_array_equal(W.gather_T(torch.as_tensor(x)).numpy(),
                                  np.asarray(RW.gather_T(jnp.asarray(x))))
    np.testing.assert_allclose(
        W.scatter_add_T(torch.as_tensor(cT)).numpy(),
        np.asarray(RW.scatter_add_T(jnp.asarray(cT))), rtol=1e-15,
        atol=1e-15)
