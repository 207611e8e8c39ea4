"""Plain PyTorch versions of the fused-epilogue primitives (counterpart
of ``raft_tpu/matrix/epilogue.py``).

The CUDA kernels in ``raft_tpu_torch/csrc`` inline these rules; the
functions here are what the kernels' plain versions call, and what the
tests hold against the reference package. The tie contract is the one
of the reference package:

- within a tile the first minimum wins (smallest column index);
- across tiles :func:`masked_fold` keeps the earlier tile on a tie
  (strict ``<``);
- a NaN counts as minimal (first NaN column wins) unless
  ``finite=True`` declares NaN-free distances.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_INT32_MAX = torch.iinfo(torch.int32).max


def argmin_ref(d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row ``(min, first-min argmin)`` of a materialized block, NaN
    minimal (``torch.min`` propagates NaN like XLA's reduce-min)."""
    _, minval, arg = iota_argmin(d, d.shape[1])
    return minval[:, 0], arg[:, 0]


def iota_argmin(d: torch.Tensor, n_valid: int, finite: bool = False):
    """Masked first-minimum argmin over a ``(tm, np_)`` tile.

    Returns ``(col, minval, arg)``: the int32 column iota (reused by
    :func:`assign_onehot`), and keepdims ``(tm, 1)`` min and argmin.
    Columns ``>= n_valid`` are masked to +inf. With ``finite=False`` a
    NaN is minimal: the min is NaN and only NaN columns are candidates.
    """
    col = torch.arange(d.shape[1], dtype=torch.int32,
                       device=d.device).expand(d.shape)
    if n_valid < d.shape[1]:
        d = torch.where(col < n_valid, d,
                        torch.full((), float("inf"), dtype=d.dtype,
                                   device=d.device))
    minval = torch.amin(d, dim=1, keepdim=True)
    cand = d == minval
    if not finite:
        cand = cand | torch.isnan(d)
    sentinel = torch.full((), _INT32_MAX, dtype=torch.int32,
                          device=d.device)
    arg = torch.amin(torch.where(cand, col, sentinel), dim=1, keepdim=True)
    return col, minval, arg


def assign_onehot(col: torch.Tensor, arg: torch.Tensor,
                  row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Boolean assignment one-hot from :func:`iota_argmin`'s outputs;
    ``row_mask`` ``(tm, 1)`` drops padded rows so they never count."""
    oh = col == arg
    if row_mask is not None:
        oh = oh & row_mask
    return oh


def label_onehot(labels: torch.Tensor, n_classes: int,
                 mask: Optional[torch.Tensor] = None,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(m, n_classes)`` one-hot of a label vector; out-of-range labels
    give all-zero rows."""
    col = torch.arange(n_classes, dtype=labels.dtype, device=labels.device)
    oh = col[None, :] == labels[:, None]
    if mask is not None:
        oh = oh & mask[:, None]
    return oh.to(dtype)


def masked_fold_ref(best_val, best_idx, minval, arg, offset: int):
    """One running-min fold step over initialized ``(val, idx)``: a
    tile's ``(min, argmin)`` replaces the running pair only when
    strictly smaller, so the earlier tile wins ties. ``offset`` rebases
    tile-local columns to global ones."""
    better = minval < best_val
    return (torch.where(better, minval, best_val),
            torch.where(better, arg + offset, best_idx))


def masked_fold(state, minval, arg, offset: int):
    """Tiled running-min epilogue: ``state`` is the running ``(val,
    idx)`` or ``None`` before the first tile, which starts it at
    ``(+inf, 0)`` as the reference package's revisited output block
    does; then one :func:`masked_fold_ref` step."""
    if state is None:
        state = (torch.full_like(minval, float("inf")),
                 torch.zeros_like(arg))
    return masked_fold_ref(state[0], state[1], minval, arg, offset)
