"""Row and column reductions (counterpart of ``raft_tpu/linalg/reduce.py``).

``reduce`` maps, reduces along one axis and maps again, as the reference
package's; ``apply`` names the axis with RAFT's vocabulary
(``ALONG_ROWS``: one value a row). The built-in reductions (``add_op``,
``min_op``, ``max_op``, ``mul_op`` of :mod:`raft_tpu_torch.core.operators`,
picked by identity) are torch reductions; a custom ``reduce_op`` folds
the axis pairwise, halving it each step.

The keyed sums (``reduce_rows_by_key``, ``reduce_cols_by_key``) group the
rows by key into a CSR matrix [n_keys, n_rows] by a stable sort and take its product with the data through ``csrc/csr_spmm.cu``
(:func:`_sums_by_key`; the plain version on CPU tensors), so each key's
rows are summed in row order, in f32 (f64 for f64 data), at every key
count and every precision tier. The reference takes a one-hot bf16x3
contraction below 1024 keys and a segment sum above; both are TPU
choices, and the in-order f32 sum is at least as exact as either.
Integer data keeps an exact sum in its own dtype (``index_add_``, exact
in any order: the kernel has no integer code); bf16 and f16 data are
summed in f32 and rounded back. Keys outside ``[0, n_unique_keys)`` are
dropped, as the reference's segment sum drops them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from raft_tpu_torch.core import operators as ops
from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.sparse.grid_spmv import _spmm

ALONG_ROWS = "along_rows"        # reduce each row -> one value per row
ALONG_COLUMNS = "along_columns"  # reduce each column -> one value per column


def _axis(apply: str) -> int:
    if apply == ALONG_ROWS:
        return 1
    if apply == ALONG_COLUMNS:
        return 0
    raise ValueError(f"apply must be ALONG_ROWS or ALONG_COLUMNS, got {apply}")


def _fold(x: torch.Tensor, fn: Callable, dim: int) -> torch.Tensor:
    """``fn`` over ``dim`` of ``x`` by halving: each step combines the
    first half with the second (an odd length keeps its last slice)."""
    while x.shape[dim] > 1:
        h = x.shape[dim] // 2
        head = fn(x.narrow(dim, 0, h), x.narrow(dim, h, h))
        if x.shape[dim] % 2:
            head = torch.cat([head, x.narrow(dim, 2 * h, 1)], dim)
        x = head
    return x.squeeze(dim)


def reduce(res, data, apply: str = ALONG_ROWS,
           init: Optional[float] = None,
           main_op: Callable = ops.identity_op,
           reduce_op: Callable = ops.add_op,
           final_op: Callable = ops.identity_op,
           inplace: bool = False, out=None):
    """Generalized reduction: ``final_op(reduce(main_op(x), init))``.

    ``init`` defaults to the reduction's identity; a custom ``reduce_op``
    has none, so it needs an explicit ``init``."""
    data = as_tensor(data, res)
    axis = _axis(apply)
    mapped = main_op(data)
    dt = mapped.dtype
    if reduce_op is ops.add_op:
        red = torch.sum(mapped, dim=axis, dtype=dt)
        if init is not None:
            red = red + torch.as_tensor(init, dtype=dt, device=red.device)
    elif reduce_op is ops.min_op:
        red = torch.amin(mapped, dim=axis)
        if init is not None:
            red = torch.minimum(red, torch.as_tensor(init, dtype=dt,
                                                     device=red.device))
    elif reduce_op is ops.max_op:
        red = torch.amax(mapped, dim=axis)
        if init is not None:
            red = torch.maximum(red, torch.as_tensor(init, dtype=dt,
                                                     device=red.device))
    elif reduce_op is ops.mul_op:
        red = torch.prod(mapped, dim=axis, dtype=dt)
        if init is not None:
            red = red * torch.as_tensor(init, dtype=dt, device=red.device)
    else:
        if init is None:
            raise ValueError(
                "a custom reduce_op needs an explicit init (its identity); "
                "there is no way to infer it")
        init_val = torch.as_tensor(init, dtype=dt, device=mapped.device)
        if mapped.shape[axis] == 0:
            shape = list(mapped.shape)
            del shape[axis]
            red = init_val.expand(shape).clone()
        else:
            red = reduce_op(init_val, _fold(mapped, reduce_op, axis))
    out_val = final_op(red)
    if inplace and out is not None:
        return reduce_op(out, out_val)
    return out_val


def coalesced_reduction(res, data, init: Optional[float] = None, **kw):
    """Reduce along the contiguous (last) dimension."""
    return reduce(res, data, apply=ALONG_ROWS, init=init, **kw)


def strided_reduction(res, data, init: Optional[float] = None, **kw):
    """Reduce along the strided (first) dimension."""
    return reduce(res, data, apply=ALONG_COLUMNS, init=init, **kw)


def _key_csr(keys: torch.Tensor, in_range: torch.Tensor, n_keys: int,
             dtype: torch.dtype, w=None):
    """``(indptr, indices, data)``: the CSR matrix [n_keys, m] that groups
    the rows where ``in_range`` holds by key, by a stable sort (each
    key's rows keep their order); the other rows sort to the end, past
    ``indptr[n_keys]``, where neither the kernel nor its plain version
    reads. Its entries are ones, or ``w`` [m] (the rows' weights), in
    ``dtype``. No host sync."""
    lab = torch.where(in_range, keys.long(), n_keys)
    lab_sorted, order = torch.sort(lab, stable=True)
    indptr = torch.searchsorted(
        lab_sorted, torch.arange(n_keys + 1, device=keys.device))
    if w is None:
        data = torch.ones(order.numel(), dtype=dtype, device=keys.device)
    else:
        data = w.to(dtype)[order]
    return indptr, order.to(torch.int32), data


def _sums_by_key(x: torch.Tensor, keys: torch.Tensor,
                 in_range: torch.Tensor, n_keys: int, w=None):
    """``(sums [n_keys, d], counts [n_keys] int64)``: the keyed rows of
    ``x`` (f32 or f64) as :func:`_key_csr` groups them, summed in row
    order by the CSR product of ``csrc/csr_spmm.cu`` (its plain version
    on the CPU), and each key's row count."""
    indptr, indices, data = _key_csr(keys, in_range, n_keys, x.dtype, w)
    return _spmm(indptr, indices, data, x, n_keys), torch.diff(indptr)


def _keyed_rows(data: torch.Tensor, keys: torch.Tensor, n_keys: int,
                w=None) -> torch.Tensor:
    """out[k] = sum of w[i] data[i] over the rows i with keys[i] == k."""
    keys = keys.to(device=data.device).long()   # narrow key dtypes widen
    in_range = (keys >= 0) & (keys < n_keys)
    if not data.is_floating_point():
        if w is not None:
            data = data * w.to(data.dtype)[:, None]
        return torch.zeros((n_keys,) + tuple(data.shape[1:]),
                           dtype=data.dtype, device=data.device).index_add_(
            0, keys[in_range], data[in_range])
    if data.dtype not in (torch.float32, torch.float64):
        if w is not None:                 # the product in data's dtype
            data, w = data * w.to(data.dtype)[:, None], None
        sums, _ = _sums_by_key(data.to(torch.float32).contiguous(), keys,
                               in_range, n_keys)
        return sums.to(data.dtype)
    return _sums_by_key(data.contiguous(), keys, in_range, n_keys, w)[0]


def reduce_rows_by_key(res, data, keys, n_unique_keys: int, weights=None):
    """Sum rows that share a key:
    ``out[k, :] = sum over i with keys[i] == k of w[i] data[i, :]``.
    Float data goes through ``csrc/csr_spmm.cu`` (module docstring)."""
    data = as_tensor(data, res)
    keys = as_tensor(keys, res)
    w = None if weights is None else as_tensor(weights, res).to(data.device)
    return _keyed_rows(data, keys, int(n_unique_keys), w)


def reduce_cols_by_key(res, data, keys, n_unique_keys: int):
    """Sum columns that share a key:
    ``out[:, k] = sum over j with keys[j] == k of data[:, j]``: the keyed
    row sum of ``data.T`` (made contiguous), transposed back."""
    data = as_tensor(data, res)
    keys = as_tensor(keys, res)
    return _keyed_rows(data.T, keys, int(n_unique_keys)).T
