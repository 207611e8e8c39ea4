"""Batched top-k selection (counterpart of ``raft_tpu/matrix/select_k.py``).

Routes, as in the reference (the dispatch bands were measured on a TPU
v5e and are kept unchanged, so the port takes the reference's route on
every shape):

- ``AUTO``: the radix select (:mod:`~raft_tpu_torch.matrix.radix_select`,
  two CUDA kernels) in ``radix_select.preferred``'s band, else the two-
  stage tiled tournament per :func:`_choose_tiled`, else the direct select;
- ``RADIX_*``: the radix select where it applies, else tiled or direct;
- ``WARPSORT_FILTERED`` / ``WARPSORT_DISTRIBUTED(_EXT)``: the insertion
  drain (:mod:`~raft_tpu_torch.matrix.topk_insert`, one CUDA kernel) for
  f32/bf16/f16 and k <= 256, else the streaming running top-k or direct;
- ``WARPSORT_IMMEDIATE``: direct.

The direct, tiled and streaming selects are ``lax.top_k`` compositions in
the reference; here they are the stable key sort of
:mod:`~raft_tpu_torch.matrix._topk_order`, which keeps ``lax.top_k``'s
order (IEEE total order, the smaller index first among equal values).
"""

from __future__ import annotations

import enum
from typing import Tuple

import torch

from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.matrix import _topk_order, radix_select, topk_insert
from raft_tpu_torch.util.math import cdiv


class SelectAlgo(enum.Enum):
    """The reference's algorithm menu, with its values."""

    AUTO = "auto"
    RADIX_8BITS = "radix_8bits"
    RADIX_11BITS = "radix_11bits"
    RADIX_11BITS_EXTRA_PASS = "radix_11bits_extra_pass"
    WARPSORT_IMMEDIATE = "warpsort_immediate"
    WARPSORT_FILTERED = "warpsort_filtered"
    WARPSORT_DISTRIBUTED = "warpsort_distributed"
    WARPSORT_DISTRIBUTED_EXT = "warpsort_distributed_ext"


def _choose_tiled(n_rows: int, n_cols: int, k: int,
                  tile: int = 8192) -> bool:
    """The reference's tiled band: wide rows, k > 16, stage-2 pool of at
    most 144 Ki candidates."""
    pool = cdiv(n_cols, tile) * k
    return n_cols >= 64 * 1024 and k > 16 and pool <= 144 * 1024


def _order_flip(values: torch.Tensor) -> torch.Tensor:
    """Strictly order-reversing, self-inverse transform: floats negate,
    integers take bitwise NOT (through int64 for the unsigned types
    PyTorch cannot invert)."""
    if values.is_floating_point():
        return -values
    if values.dtype in (torch.uint16, torch.uint32):
        top = 0xFFFF if values.dtype == torch.uint16 else 0xFFFFFFFF
        return (top - values.to(torch.int64)).to(values.dtype)
    return ~values


def _direct_select(values: torch.Tensor, k: int, select_min: bool):
    """``(vals, int64 positions)``: the k smallest (or largest) in
    ``lax.top_k``'s order."""
    return _topk_order.topk(values, k, largest=not select_min)


def _pad_lowest(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def _flip_pad_rows(values: torch.Tensor, k: int, select_min: bool,
                   tile: int):
    """Shared selection prologue: ``(v, n_tiles, tile)`` with the rows
    order-flipped for select_min and padded to a tile multiple with the
    lowest-sorting value, or ``None`` when one tile covers the row."""
    n_rows, n_cols = values.shape
    tile = max(tile, k)
    if n_cols <= tile:
        return None
    v = _order_flip(values) if select_min else values
    n_tiles = cdiv(n_cols, tile)
    padded = n_tiles * tile
    if padded != n_cols:
        v = torch.nn.functional.pad(v, (0, padded - n_cols),
                                    value=_pad_lowest(v.dtype))
    return v, n_tiles, tile


def _tiled_select(values: torch.Tensor, k: int, select_min: bool,
                  tile: int = 8192):
    n_rows, n_cols = values.shape
    pre = _flip_pad_rows(values, k, select_min, tile)
    if pre is None:
        return _direct_select(values, k, select_min)
    v, n_tiles, tile = pre
    # stage 1: per-tile top-k; stage 2: top-k of the candidate pool
    tvals, tidx = _topk_order.topk(v.reshape(n_rows, n_tiles, tile), k)
    base = (torch.arange(n_tiles, device=v.device) * tile)[None, :, None]
    pool_v = tvals.reshape(n_rows, -1)
    pool_i = (tidx + base).reshape(n_rows, -1)
    fvals, fpos = _topk_order.topk(pool_v, k)
    fidx = torch.gather(pool_i, 1, fpos)
    return (_order_flip(fvals) if select_min else fvals), fidx


def _stream_select(values: torch.Tensor, k: int, select_min: bool,
                   tile: int = 8192):
    """Single-pass streaming selection: fold each tile into a running
    k-buffer by one top-k over the [buffer | tile] pool, seeded from
    tile 0."""
    n_rows, n_cols = values.shape
    pre = _flip_pad_rows(values, k, select_min, tile)
    if pre is None:
        return _direct_select(values, k, select_min)
    v, n_tiles, tile = pre
    bv, bi = _topk_order.topk(v[:, :tile], k)
    for off in range(tile, n_tiles * tile, tile):
        cv, ci = _topk_order.topk(v[:, off:off + tile], k)
        pool_v = torch.cat([bv, cv], dim=1)
        pool_i = torch.cat([bi, ci + off], dim=1)
        bv, pos = _topk_order.topk(pool_v, k)
        bi = torch.gather(pool_i, 1, pos)
    return (_order_flip(bv) if select_min else bv), bi


def select_k(res, values, k: int, select_min: bool = True,
             in_idx=None, algo: SelectAlgo = SelectAlgo.AUTO,
             sorted: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched top-k: smallest (select_min) or largest k per row.

    ``values``: [batch, len] (or [len]); optional ``in_idx`` [batch, len]
    gives payload indices to return instead of positions. Returns
    ``(out_val [batch, k], out_idx [batch, k])`` sorted best-first,
    positions as int32. A non-tensor input goes to ``res``'s device
    (``cuda:0`` by default)."""
    values = as_tensor(values, res)
    squeeze = values.dim() == 1
    if squeeze:
        values = values[None, :]
    n_rows, n_cols = values.shape
    if k > n_cols:
        raise ValueError(f"k={k} > len={n_cols}")

    def _radix_ok():
        return radix_select.supports(values.dtype, n_cols, k)

    if algo == SelectAlgo.AUTO:
        if radix_select.preferred(n_cols, k) and _radix_ok():
            mode = "radix"
        elif _choose_tiled(n_rows, n_cols, k):
            mode = "tiled"
        else:
            mode = "direct"
    elif algo in (SelectAlgo.RADIX_8BITS, SelectAlgo.RADIX_11BITS,
                  SelectAlgo.RADIX_11BITS_EXTRA_PASS):
        if _radix_ok():
            mode = "radix"
        else:
            mode = "tiled" if n_cols > 8192 else "direct"
    elif algo in (SelectAlgo.WARPSORT_FILTERED,
                  SelectAlgo.WARPSORT_DISTRIBUTED,
                  SelectAlgo.WARPSORT_DISTRIBUTED_EXT):
        if topk_insert.supports(values.dtype, k):
            mode = "insert"
        else:
            mode = "stream" if n_cols > 8192 else "direct"
    else:
        mode = "direct"

    if mode == "radix":
        out_val, out_idx = radix_select.radix_select_k(values, k, select_min)
    elif mode == "insert":
        out_val, out_idx = topk_insert.insert_select(values, k, select_min)
    elif mode == "tiled":
        out_val, out_idx = _tiled_select(values, k, select_min)
    elif mode == "stream":
        out_val, out_idx = _stream_select(values, k, select_min)
    else:
        out_val, out_idx = _direct_select(values, k, select_min)

    if in_idx is not None:
        in_idx = torch.as_tensor(in_idx, device=values.device)
        if in_idx.dim() == 1:
            in_idx = in_idx[None, :]
        out_idx = torch.gather(in_idx, 1, out_idx.to(torch.int64))
    else:
        out_idx = out_idx.to(torch.int32)

    if squeeze:
        return out_val[0], out_idx[0]
    return out_val, out_idx
