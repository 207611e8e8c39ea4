"""Sparse linear algebra (counterpart of ``raft_tpu/sparse/linalg.py``).

``spmv`` and ``spmm`` on a CSR operand on a CUDA device always go to the
CSR kernels (``grid_spmv``: csrc/csr_spmv.cu, csrc/csr_spmm.cu), whatever
the nnz: on Hopper the reference's grid, ELL and segment formulations are
one function, so neither ``RAFT_TPU_SPMV`` nor the reference's TPU bands
(``_GRID_MIN_NNZ``, ``_GRID_MAX_PAD_RATIO``) are carried over. A CSR
operand on the CPU runs the kernels' plain versions. The structure ops
(transpose, symmetrize, Laplacian) run as torch ops on the operand's
device where the reference runs numpy on the host; they give the
reference's structure exactly, and float sums (degrees, row sums) to
f32 reassociation.

Not ported yet: ``sddmm`` and ``masked_matmul`` (ROADMAP.md, queue A
item 11), the ``ELLMatrix`` operand, guard modes other than ``off``, and
the ``runtime.limits`` admission (queue A item 13).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from raft_tpu_torch.core.guards import resolve_guard_mode
from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.core.sparse_types import COOMatrix, CSRMatrix
from raft_tpu_torch.sparse import convert, grid_spmv, op

__all__ = ["spmv", "spmm", "spmv_method", "csr_add", "coo_degree", "degree",
           "rows_sum", "csr_row_normalize_l1", "csr_row_normalize_max",
           "transpose", "coo_symmetrize", "symmetrize",
           "symmetrize_knn_graph", "laplacian", "laplacian_normalized",
           "csr_row_norm"]


def spmv_method(a=None, x=None) -> str:
    """``"grid"``: every CSR operand takes the kernel route. Kept so that
    callers of the reference's dispatch find it; there is nothing to
    choose on Hopper (see the module docstring)."""
    return "grid"


def _plan(a) -> grid_spmv.GridSpMV:
    if isinstance(a, grid_spmv.GridSpMV):
        return a
    if isinstance(a, CSRMatrix):
        return _cached_plan(a)
    raise TypeError(f"expected a CSRMatrix or GridSpMV, got "
                    f"{type(a).__name__}")


def spmv(a, x, guard_mode=None) -> torch.Tensor:
    """y = A·x for a CSRMatrix or a prepared GridSpMV plan. The result is
    f32, or f64 where A or x is f64. A non-tensor x goes to ``cuda:0``."""
    resolve_guard_mode(guard_mode, "sparse.linalg.spmv")
    return grid_spmv.spmv(_plan(a), x)


def _cached_plan(a):
    """The matrix's plan, built once and memoized on the object."""
    plan = getattr(a, "_grid_plan", None)
    if plan is None:
        plan = grid_spmv.prepare(a)
        with contextlib.suppress(AttributeError):
            a._grid_plan = plan
    return plan


def spmm(a, b, alpha=1.0, beta=0.0, c=None) -> torch.Tensor:
    """C = alpha·A·B + beta·C for sparse A [m, n] (CSRMatrix or GridSpMV)
    and dense B [n, k]. A non-tensor B or C goes to ``cuda:0``."""
    out = alpha * grid_spmv.spmm(_plan(a), b)
    if c is not None and beta != 0.0:
        out = out + beta * as_tensor(c)
    return out


def csr_add(a: CSRMatrix, b: CSRMatrix) -> CSRMatrix:
    """C = A + B with the union of the two structures."""
    coo_a, coo_b = convert.csr_to_coo(a), convert.csr_to_coo(b)
    merged = op.sum_duplicates(COOMatrix(
        torch.cat([coo_a.rows, coo_b.rows]),
        torch.cat([coo_a.cols, coo_b.cols]),
        torch.cat([coo_a.data, coo_b.data]), a.shape))
    return convert.sorted_coo_to_csr(merged)


def coo_degree(coo: COOMatrix) -> torch.Tensor:
    """Per-row entry count, in the rows' dtype."""
    return torch.bincount(coo.rows.long(), minlength=coo.n_rows).to(
        coo.rows.dtype)


def _segment_sum(vals, row_ids, n_rows: int):
    return torch.zeros(n_rows, dtype=vals.dtype,
                       device=vals.device).index_add_(0, row_ids.long(), vals)


def _segment_max(vals, row_ids, n_rows: int):
    """Row max; an empty row gives 0 (both callers clamp it there)."""
    return torch.zeros(n_rows, dtype=vals.dtype,
                       device=vals.device).scatter_reduce_(
        0, row_ids.long(), vals, "amax", include_self=False)


def rows_sum(csr: CSRMatrix) -> torch.Tensor:
    """Per-row value sum (the degree of an adjacency)."""
    return _segment_sum(csr.data, csr.row_ids(), csr.n_rows)


def csr_row_normalize_l1(csr: CSRMatrix) -> CSRMatrix:
    """Scale each row to unit L1 norm (an all-zero row stays)."""
    row_ids = csr.row_ids().long()
    norms = _segment_sum(csr.data.abs(), row_ids, csr.n_rows)
    norms = torch.where(norms == 0, torch.ones_like(norms), norms)
    return CSRMatrix(csr.indptr, csr.indices, csr.data / norms[row_ids],
                     csr.shape)


def csr_row_normalize_max(csr: CSRMatrix) -> CSRMatrix:
    """Scale each row by its max value (rows whose max is <= 0 stay)."""
    row_ids = csr.row_ids().long()
    maxs = _segment_max(csr.data, row_ids, csr.n_rows)
    maxs = torch.where(maxs <= 0, torch.ones_like(maxs), maxs)
    return CSRMatrix(csr.indptr, csr.indices, csr.data / maxs[row_ids],
                     csr.shape)


def transpose(csr: CSRMatrix) -> CSRMatrix:
    """CSR transpose: the flipped COO, sorted."""
    coo = convert.csr_to_coo(csr)
    flipped = COOMatrix(coo.cols, coo.rows, coo.data,
                        (csr.n_cols, csr.n_rows))
    return convert.sorted_coo_to_csr(op.coo_sort(flipped))


def coo_symmetrize(coo: COOMatrix, reduceat=np.add.reduceat) -> COOMatrix:
    """Merge A with Aᵀ under a reduction (default sum), dropping zeros;
    ``reduceat`` as in :func:`~raft_tpu_torch.sparse.op.reduce_duplicates`.
    """
    n = max(coo.shape)
    doubled = COOMatrix(torch.cat([coo.rows, coo.cols]),
                        torch.cat([coo.cols, coo.rows]),
                        torch.cat([coo.data, coo.data]), (n, n))
    return op.coo_remove_zeros(op.reduce_duplicates(doubled, reduceat))


def symmetrize_knn_graph(knn_indices, knn_dists, res=None) -> COOMatrix:
    """Union of the directed k-NN edges [n, k] and their reverses,
    max-merged. Non-tensor inputs go to the handle's device."""
    idx = as_tensor(knn_indices, res)
    dist = as_tensor(knn_dists, res)
    n, k = idx.shape
    rows = torch.arange(n, dtype=idx.dtype,
                        device=idx.device).repeat_interleave(k)
    coo = COOMatrix(rows, idx.reshape(-1), dist.reshape(-1), (n, n))
    return coo_symmetrize(coo, np.maximum.reduceat)


def _off_diagonal(csr: CSRMatrix):
    coo = convert.csr_to_coo(csr)
    keep = coo.rows != coo.cols
    return coo.rows[keep], coo.cols[keep], coo.data[keep]


def laplacian(csr: CSRMatrix) -> CSRMatrix:
    """Graph Laplacian L = D − A: self-loops are dropped and each row gains
    its degree on the diagonal."""
    if csr.n_rows != csr.n_cols:
        raise ValueError("Laplacian requires a square adjacency matrix")
    rows, cols, vals = _off_diagonal(csr)
    n = csr.n_rows
    deg = _segment_sum(vals, rows, n)
    diag_rows = torch.arange(n, dtype=rows.dtype, device=rows.device)
    merged = COOMatrix(torch.cat([rows, diag_rows]),
                       torch.cat([cols, diag_rows.to(cols.dtype)]),
                       torch.cat([-vals, deg]), (n, n))
    return convert.sorted_coo_to_csr(op.coo_sort(merged))


def laplacian_normalized(csr: CSRMatrix) -> CSRMatrix:
    """D^{-1/2}·L·D^{-1/2}; a zero degree counts as one."""
    lap = laplacian(csr)
    rows, _, vals = _off_diagonal(csr)
    deg = _segment_sum(vals, rows, csr.n_rows).to(lap.data.dtype)
    deg = torch.where(deg == 0, torch.ones_like(deg), deg)
    inv_sqrt = 1.0 / torch.sqrt(deg)
    vals = (lap.data * inv_sqrt[lap.row_ids().long()]
            * inv_sqrt[lap.indices.long()])
    return CSRMatrix(lap.indptr, lap.indices, vals, lap.shape)


def csr_row_norm(csr: CSRMatrix, norm_type: str = "l2") -> torch.Tensor:
    """Per-row ``l1``, ``l2`` or ``linf`` norm of the stored values."""
    rows = csr.row_ids()
    if norm_type == "l1":
        return _segment_sum(csr.data.abs(), rows, csr.n_rows)
    if norm_type == "l2":
        return torch.sqrt(_segment_sum(csr.data * csr.data, rows,
                                       csr.n_rows))
    if norm_type == "linf":
        return _segment_max(csr.data.abs(), rows, csr.n_rows)
    raise ValueError(f"norm_type must be l1|l2|linf, got {norm_type}")


# The reference's spellings (sparse/linalg/{degree,symmetrize}.cuh).
degree = coo_degree
symmetrize = coo_symmetrize
