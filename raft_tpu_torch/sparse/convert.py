"""Format conversions (counterpart of ``raft_tpu/sparse/convert.py``).

The reference runs these on the host in numpy; here they are torch ops on
the input's device (bincount, cumsum, nonzero, repeat_interleave). Their
output is the reference's exactly: the same ``indptr``, ``indices`` and
``data``, bit for bit, with the same dtypes.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.core.sparse_types import COOMatrix, CSRMatrix

__all__ = ["sorted_coo_to_csr", "coo_to_csr", "csr_to_coo", "dense_to_csr",
           "csr_to_dense", "adj_to_csr", "bitmap_to_csr", "bitset_to_csr"]


def _counts_to_indptr(rows: torch.Tensor, n_rows: int,
                      dtype=torch.int32) -> torch.Tensor:
    """Row-occurrence counts -> CSR indptr (shared by every *_to_csr)."""
    counts = torch.bincount(rows.long(), minlength=n_rows)
    indptr = torch.zeros(n_rows + 1, dtype=dtype, device=rows.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return indptr


def sorted_coo_to_csr(coo: COOMatrix) -> CSRMatrix:
    """Row-sorted COO -> CSR; ``indptr`` takes the rows' dtype. Sort with
    ``op.coo_sort`` first."""
    indptr = _counts_to_indptr(coo.rows, coo.n_rows, dtype=coo.rows.dtype)
    return CSRMatrix(indptr, coo.cols, coo.data, coo.shape)


def csr_to_coo(csr: CSRMatrix) -> COOMatrix:
    """CSR -> COO over the LOGICAL entries (pad entries dropped)."""
    n = csr.logical_nnz()
    rows = csr.row_ids()[:n]
    return COOMatrix(rows, csr.indices[:n], csr.data[:n], csr.shape)


def dense_to_csr(dense, tol: float = 0.0, res=None) -> CSRMatrix:
    """Dense -> CSR keeping entries with ``|x| > tol``, in row-major
    order. A non-tensor input goes to the handle's device."""
    d = as_tensor(dense, res)
    rows, cols = torch.nonzero(d.abs() > tol, as_tuple=True)
    indptr = _counts_to_indptr(rows, d.shape[0])
    return CSRMatrix(indptr, cols.to(torch.int32), d[rows, cols],
                     tuple(d.shape))


def csr_to_dense(csr: CSRMatrix) -> torch.Tensor:
    """CSR -> dense, scatter-adding every physical entry (pads add 0)."""
    out = torch.zeros(csr.shape, dtype=csr.data.dtype, device=csr.device)
    return out.index_put_((csr.row_ids().long(), csr.indices.long()),
                          csr.data, accumulate=True)


def adj_to_csr(adj, row_ind: Optional[torch.Tensor] = None,
               res=None) -> CSRMatrix:
    """Boolean adjacency -> CSR with f32 unit values. ``row_ind`` is
    accepted for the reference's signature and not used (the reference
    does not use it either)."""
    a = as_tensor(adj, res).to(torch.bool)
    rows, cols = torch.nonzero(a, as_tuple=True)
    indptr = _counts_to_indptr(rows, a.shape[0])
    data = torch.ones(rows.shape[0], dtype=torch.float32, device=a.device)
    return CSRMatrix(indptr, cols.to(torch.int32), data, tuple(a.shape))


def bitmap_to_csr(bitmap) -> CSRMatrix:
    raise NotImplementedError(
        "bitmap_to_csr needs core/bitset, which is not ported yet "
        "(ROADMAP.md, queue A item 12)")


def bitset_to_csr(bitset, n_rows: int) -> CSRMatrix:
    raise NotImplementedError(
        "bitset_to_csr needs core/bitset, which is not ported yet "
        "(ROADMAP.md, queue A item 12)")


# The reference's spelling (sparse/convert/csr.cuh: coo_to_csr).
coo_to_csr = sorted_coo_to_csr
