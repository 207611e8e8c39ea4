"""Per-column histogram (counterpart of ``raft_tpu/stats/histogram.py``).

One ``torch.bincount`` over ``bin * n_cols + col`` gives the exact
integer counts of every column at any bin count. The reference's three
routes (a one-hot sum up to 512 bins, a factored one-hot contraction up
to 2^14, a scatter-add beyond) work round the TPU's lack of atomics; on
the card the count is one atomic add an item. ``HistType`` keeps the
reference's vocabulary: it is validated and chooses nothing, as the
tile knobs of queue A item 17 do.
"""

from __future__ import annotations

import enum

import torch

from raft_tpu_torch.core.resources import as_tensor

_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


class HistType(enum.Enum):
    """The reference's strategy names, with its values."""

    SmemBits1 = 1
    SmemBits2 = 2
    SmemBits4 = 4
    SmemBits8 = 8
    SmemBits16 = 16
    Gmem = "gmem"
    Smem = "smem"
    SmemMatchAny = "smem_match_any"
    SmemHash = "smem_hash"
    Auto = "auto"


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    """Bins as int32: floats truncate toward zero; NaN, inf and values
    past the int32 range give INT32_MIN, outside every bin (as numpy's
    cast gives the reference its bins from an array)."""
    if v.is_floating_point():
        v = v.to(torch.float64).trunc()
        v = torch.where((v >= _I32_MIN) & (v <= _I32_MAX), v,
                        torch.full_like(v, _I32_MIN))
    return v.to(torch.int64).clamp(_I32_MIN, _I32_MAX).to(torch.int32)


def histogram(data, n_bins: int, binner=None,
              hist_type: HistType = HistType.Auto):
    """Per-column histogram of ``data`` [n_rows, n_cols] (or [n_rows]):
    int32 [n_bins, n_cols].

    ``binner(value, row, col)`` maps values to bins (default: the value
    cast to int32, the reference's identity binner); bins outside
    ``[0, n_bins)`` are dropped."""
    if not isinstance(hist_type, HistType):
        raise ValueError(f"hist_type must be a HistType, got {hist_type!r}")
    data = as_tensor(data)
    if data.dim() == 1:
        data = data[:, None]
    n_rows, n_cols = data.shape
    dev = data.device
    if binner is None:
        bins = _to_int32(data)
    else:
        rows = torch.arange(n_rows, device=dev)[:, None]
        cols = torch.arange(n_cols, device=dev)[None, :]
        bins = _to_int32(torch.as_tensor(binner(data, rows, cols),
                                         device=dev))
    bins = bins.long()
    valid = (bins >= 0) & (bins < n_bins)
    flat = bins * n_cols + torch.arange(n_cols, device=dev)[None, :]
    counts = torch.bincount(flat[valid], minlength=n_bins * n_cols)
    return counts.reshape(n_bins, n_cols).to(torch.int32)
