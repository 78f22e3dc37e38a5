"""The fixed-order scatter-adds of the port (spaces/fixed_order.py) on the
CPU: FunctionSpace / MixedSpace scatter_add and scatter_add_T and the
penalty facet residual give the same values as `index_add` (which adds in
source order on the CPU; torch.equal, so only the sign of a zero sum may
differ), on the PAV wing's spaces (the gmsh tables only, no model) and on
the 6x10 generated wing. Inputs are made with numpy from a seed; f64."""

import os

import numpy as np
import pytest
import torch

from femo_alpha_tpu_torch.mesh import createWingShellMesh, readFEAMesh
from femo_alpha_tpu_torch.models.rm_shell.pde import RMShellPDE
from femo_alpha_tpu_torch.spaces import FunctionSpace, MixedSpace

PAV_WING = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "pav_like_wing_2388.msh")

_MESHES = {}


def _mesh(name):
    if name not in _MESHES:
        _MESHES[name] = (readFEAMesh(PAV_WING) if name == "pav" else
                         createWingShellMesh(6, 10, rib_stations=(5,)))
    return _MESHES[name]


def _space(mesh, kind):
    if kind == "mixed":
        return MixedSpace(FunctionSpace(mesh, "P", 2, value_size=3),
                          FunctionSpace(mesh, "P", 1, value_size=3))
    fam, deg, vs = {"P2v3": ("P", 2, 3), "P1": ("P", 1, 1),
                    "DG0": ("DG", 0, 1)}[kind]
    return FunctionSpace(mesh, fam, deg, value_size=vs)


def _index_add(dofmap, n, cell_vals):
    idx = torch.as_tensor(dofmap, dtype=torch.int64).reshape(-1)
    return cell_vals.new_zeros(n).index_add(0, idx, cell_vals.reshape(-1))


@pytest.mark.parametrize("kind", ["mixed", "P2v3", "P1", "DG0"])
@pytest.mark.parametrize("mesh_name", ["pav", "wing6x10"])
def test_scatter_add_equals_index_add(mesh_name, kind):
    W = _space(_mesh(mesh_name), kind)
    rng = np.random.default_rng(len(kind))
    cv = torch.as_tensor(rng.standard_normal((W.mesh.n_cells, W.nd_local)))
    ref = _index_add(W.dofmap, W.n_dofs, cv)
    assert torch.equal(W.scatter_add(cv), ref)
    assert torch.equal(W.scatter_add_T(cv.T.contiguous()), ref)


def test_facet_residual_equals_index_add():
    """The penalty facet residual on the facets of the inner third of the
    span (exterior and interior facets, four local-facet groups, dofs
    shared between groups) against the per-group index_add it replaced."""
    mesh = _mesh("wing6x10")
    pde = RMShellPDE(mesh, element_wise_material=True, device="cpu")
    span = mesh.coords[:, 1].max()
    ff = pde.make_penalty_facet_form(lambda x: x[:, 1] < 0.35 * span)
    assert len(ff.groups) > 1
    rng = np.random.default_rng(7)
    nel, nn = mesh.n_cells, mesh.n_nodes
    p = {"thickness": torch.as_tensor(rng.uniform(0.01, 0.02, nel)),
         "E": torch.full((nel,), 7e10, dtype=torch.float64),
         "nu": torch.full((nel,), 0.33, dtype=torch.float64),
         "uhat": torch.as_tensor(1e-3 * rng.standard_normal(3 * nn)),
         "F_solid": torch.zeros(3 * nn, dtype=torch.float64)}
    u = torch.as_tensor(1e-3 * rng.standard_normal(pde.W.n_dofs))
    ref = u.new_zeros(pde.W.n_dofs)
    for g in ff.groups:
        rc = ff._batch(g["kernel"], u, p, g["cells"])
        ref = ref.index_add(
            0, torch.as_tensor(pde.W.dofmap[g["cells"]],
                               dtype=torch.int64).reshape(-1),
            rc.reshape(-1))
    assert torch.equal(ff.assemble_residual(u, p), ref)
