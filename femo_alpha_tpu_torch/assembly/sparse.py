"""CSR sparsity pattern precomputed on the host; assembly and products in a
fixed order.

Port of femo_alpha_tpu/assembly/sparse.py::CSRPattern, for preconditioner
construction, host reference checks and export; the solve path stays
matrix-free (the fused constrained operator). Both sums go through
spaces/fixed_order.py, never `index_add_`: on the card that adds with
atomics, and the same element matrices would give other CSR bits from
run to run.
"""

from __future__ import annotations

import numpy as np
import torch

from ..native import build_csr_pattern
from ..spaces.fixed_order import fixed_order_scatter, sum_plan


class CSRPattern:
    """The CSR pattern of a dofmap (nc, nd) on n_dofs dofs: `indptr`,
    `indices` (int32 numpy), `nnz`; `assemble(Ae)` gives the data (nnz,)
    of cell-major element matrices (nc, nd, nd), `matvec(data, x)` the
    product with a vector, both on the tensors' device."""

    def __init__(self, dofmap, n_dofs):
        order, seg, row_ids, cols = build_csr_pattern(np.asarray(dofmap),
                                                      n_dofs)
        self.n = int(n_dofs)
        self.nnz = len(cols)
        self.indices = cols
        self.row_ids = row_ids
        counts = np.bincount(row_ids, minlength=self.n)
        self.indptr = np.concatenate([[0], np.cumsum(counts)]).astype(
            np.int32)
        # each slot sums its entries in flat element-matrix order (the
        # order `order` visits them in)
        self._slot = np.empty(len(order), dtype=np.int64)
        self._slot[order] = seg
        self._index_cache = {}

    def _on(self, name, arr, device):
        key = (name, str(device))
        t = self._index_cache.get(key)
        if t is None:
            t = self._index_cache[key] = torch.as_tensor(
                np.asarray(arr, dtype=np.int64), device=device)
        return t

    def assemble(self, Ae):
        """Element matrices (nc, nd, nd) -> CSR data (nnz,)."""
        plan = sum_plan(self, "assemble", self._slot, Ae.device)
        return fixed_order_scatter(Ae.reshape(-1), plan, self.nnz)

    def matvec(self, data, x):
        """(A x) (n,) for CSR data (nnz,): each row sums its entries in
        column order."""
        plan = sum_plan(self, "rows", self.row_ids, data.device)
        cols = self._on("cols", self.indices, data.device)
        return fixed_order_scatter(data * x[cols], plan, self.n)

    def to_scipy(self, data):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (np.asarray(torch.as_tensor(data).detach().cpu()), self.indices,
             self.indptr), shape=(self.n, self.n))

    def to_dense(self, data):
        return np.asarray(self.to_scipy(data).todense())
