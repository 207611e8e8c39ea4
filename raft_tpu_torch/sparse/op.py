"""Structural COO/CSR operations (counterpart of ``raft_tpu/sparse/op.py``).

The reference sorts, filters and merges on the host in numpy; here the
same steps are torch ops on the input's device (a stable sort of the
(row, col) key, masks, segment reductions), with the same output.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from raft_tpu_torch.core.sparse_types import COOMatrix, CSRMatrix

__all__ = ["coo_sort", "coo_remove_scalar", "coo_remove_zeros",
           "max_duplicates", "sum_duplicates", "reduce_duplicates",
           "csr_row_op", "csr_row_slice"]

# the numpy reductions the reference's API takes, by their torch name
_REDUCE = ((np.add.reduceat, "sum"), (np.maximum.reduceat, "amax"),
           (np.minimum.reduceat, "amin"), (np.multiply.reduceat, "prod"))


def _sort_order(rows: torch.Tensor, cols: torch.Tensor, n_cols: int):
    """Stable (row, col) order: ``np.lexsort((cols, rows))``."""
    key = rows.long() * max(n_cols, 1) + cols.long()
    return torch.argsort(key, stable=True)


def coo_sort(coo: COOMatrix) -> COOMatrix:
    """Sort COO entries by (row, col), stably."""
    order = _sort_order(coo.rows, coo.cols, coo.n_cols)
    return COOMatrix(coo.rows[order], coo.cols[order], coo.data[order],
                     coo.shape)


def coo_remove_scalar(coo: COOMatrix, scalar) -> COOMatrix:
    """Drop the entries equal to ``scalar``."""
    keep = coo.data != scalar
    return COOMatrix(coo.rows[keep], coo.cols[keep], coo.data[keep],
                     coo.shape)


def coo_remove_zeros(coo: COOMatrix) -> COOMatrix:
    return coo_remove_scalar(coo, 0)


def max_duplicates(coo: COOMatrix) -> COOMatrix:
    """Merge duplicate (row, col) entries keeping the max value."""
    return reduce_duplicates(coo, np.maximum.reduceat)


def sum_duplicates(coo: COOMatrix) -> COOMatrix:
    """Merge duplicate (row, col) entries by summing."""
    return reduce_duplicates(coo, np.add.reduceat)


def _run_fold(data: torch.Tensor, starts: torch.Tensor,
              name: str) -> torch.Tensor:
    """The sum or product of each run ``data[starts[i]:starts[i + 1]]`` in
    numpy's reduce order: a product folds left to right from the first
    entry; a sum adds the rest left to right from zero, then the first
    entry (numpy's order for runs shorter than 9, past which numpy adds
    the rest pairwise). Runs are visited longest first, so step ``p``
    folds in position ``p`` of a prefix of them: no atomics, and the same
    bits on every device and from run to run."""
    lengths = torch.diff(starts, append=starts.new_tensor([data.shape[0]]))
    merged = data[starts].clone()
    multi = torch.nonzero(lengths > 1)[:, 0]
    if not multi.numel():
        return merged
    longest, order = torch.sort(lengths[multi], descending=True, stable=True)
    multi, first = multi[order], starts[multi[order]]
    # active[p]: how many runs have at least p entries, a prefix of multi
    active = torch.flip(torch.cumsum(torch.flip(torch.bincount(longest), [0]),
                                     0), [0]).tolist()
    acc = (torch.zeros(multi.shape[0], dtype=data.dtype, device=data.device)
           if name == "sum" else data[first].clone())
    for p in range(1, len(active) - 1):
        k = active[p + 1]
        if name == "sum":
            acc[:k] += data[first[:k] + p]
        else:
            acc[:k] *= data[first[:k] + p]
    merged[multi] = data[first] + acc if name == "sum" else acc
    return merged


def reduce_duplicates(coo: COOMatrix,
                      reduceat: Callable = np.add.reduceat) -> COOMatrix:
    """Sort by (row, col) and reduce each run of equal keys with
    ``reduceat``, a numpy ``reduceat`` as in the reference.
    ``np.add``/``np.maximum``/``np.minimum``/``np.multiply.reduceat`` run
    as torch ops on the device; any other runs on the host. max/min are
    exact; sums and products fold each run in one fixed order on every
    device (:func:`_run_fold`), numpy's own except for sums of runs
    longer than 8."""
    rows, cols, data = coo.rows, coo.cols, coo.data
    if rows.shape[0] == 0:
        return coo
    order = _sort_order(rows, cols, coo.n_cols)
    rows, cols, data = rows[order], cols[order], data[order]
    new_run = torch.ones_like(rows, dtype=torch.bool)
    new_run[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    starts = torch.nonzero(new_run)[:, 0]
    name = next((n for f, n in _REDUCE if f == reduceat), None)
    if name is None:
        merged = torch.as_tensor(
            reduceat(data.cpu().numpy(), starts.cpu().numpy()),
            device=data.device)
    elif name in ("sum", "prod"):
        merged = _run_fold(data, starts, name)
    else:
        run = torch.cumsum(new_run.long(), 0) - 1
        merged = torch.zeros(starts.shape[0], dtype=data.dtype,
                             device=data.device).scatter_reduce_(
            0, run, data, name, include_self=False)
    return COOMatrix(rows[starts], cols[starts], merged, coo.shape)


def csr_row_op(csr: CSRMatrix, fn):
    """``fn(row_ids, values)`` over the LOGICAL entries (pad entries are
    sliced off first)."""
    csr = csr.depad()
    return fn(csr.row_ids(), csr.data)


def csr_row_slice(csr: CSRMatrix, start: int, stop: int) -> CSRMatrix:
    """Rows ``[start, stop)`` as a new CSR matrix."""
    lo, hi = int(csr.indptr[start]), int(csr.indptr[stop])
    return CSRMatrix(csr.indptr[start:stop + 1] - lo,
                     csr.indices[lo:hi], csr.data[lo:hi],
                     (stop - start, csr.n_cols))
