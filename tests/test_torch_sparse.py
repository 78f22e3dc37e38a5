"""The CSR pattern of femo_alpha_tpu_torch (assembly/sparse.py and its
numpy native/topology.py::build_csr_pattern) against the reference's on the
shell's mixed space of an unstructured wing (createWingShellMesh 6x8, ribs
at 4): the pattern's tables equal, indptr and indices equal, the
assembled data within 1e-14, and the CSR product equal to the fused
operator's plain twin within 1e-14."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from femo_alpha_tpu.assembly.sparse import CSRPattern as RefCSR
from femo_alpha_tpu.native import build_csr_pattern as ref_pattern

from femo_alpha_tpu_torch.assembly import CSRPattern
from femo_alpha_tpu_torch.assembly.cuda_kernels import (
    constrained_matvec_T_plain,
)
from femo_alpha_tpu_torch.mesh import createWingShellMesh
from femo_alpha_tpu_torch.models.rm_shell.pde import RMShellPDE
from femo_alpha_tpu_torch.native import build_csr_pattern


@pytest.fixture(scope="module")
def wing():
    m = createWingShellMesh(n_chord=6, n_span=8, rib_stations=(4,))
    W = RMShellPDE(m, element_wise_material=True, device="cpu").W
    nd = W.dofmap.shape[1]
    rng = np.random.default_rng(5)
    Ae = rng.standard_normal((m.n_cells, nd, nd))
    return W, Ae


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_pattern_tables_equal(wing):
    W, _ = wing
    got = build_csr_pattern(W.dofmap, W.n_dofs)
    want = ref_pattern(np.asarray(W.dofmap), W.n_dofs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_csr_matches_reference(wing):
    W, Ae = wing
    csr, ref = CSRPattern(W.dofmap, W.n_dofs), RefCSR(W.dofmap, W.n_dofs)
    np.testing.assert_array_equal(csr.indptr, ref.indptr)
    np.testing.assert_array_equal(csr.indices, ref.indices)
    assert csr.nnz == ref.nnz
    data = csr.assemble(torch.as_tensor(Ae))
    data_ref = np.asarray(ref.assemble(jnp.asarray(Ae)))
    assert _rel(data.numpy(), data_ref) <= 1e-14
    dense = csr.to_dense(data)
    assert _rel(dense, ref.to_dense(data_ref)) <= 1e-14


def test_csr_matvec_matches_fused_twin(wing):
    W, Ae = wing
    csr = CSRPattern(W.dofmap, W.n_dofs)
    data = csr.assemble(torch.as_tensor(Ae))
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(W.n_dofs))
    Ae_T = torch.as_tensor(np.ascontiguousarray(np.moveaxis(Ae, 0, -1)))
    ones = torch.ones(W.n_dofs, dtype=torch.float64)
    y = csr.matvec(data, x)
    y_fused = constrained_matvec_T_plain(Ae_T, x, ones,
                                         *W.lane_tables("cpu"))
    assert _rel(y.numpy(), y_fused.numpy()) <= 1e-14
