"""Stable top-k in the order of XLA's ``lax.top_k`` (port-only helper).

The reference package selects with ``lax.top_k`` outside its Pallas
kernels: the direct select, the tiled, stream and scan merges, the
masked top-k epilogue and the best-first sort of the radix select. Its
order is IEEE total order on the value — ``+0.0`` ranks above ``-0.0``,
``+NaN`` above ``+inf`` and ``-NaN`` below ``-inf`` — and among equal
values the smaller index wins. ``torch.topk`` promises neither, and
``torch.sort`` treats ``-0.0 == +0.0``, so this module sorts the integer
*sortable key* of each value (the bit fold of the reference's
``radix_select._to_key``) with a stable sort. Plain PyTorch on the card:
the reference computes these in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

_I32_MAX = 0x7FFFFFFF
_I64_MAX = 0x7FFFFFFFFFFFFFFF


def sortable_key(values: torch.Tensor) -> torch.Tensor:
    """Order-preserving integer image of ``values``: ascending key is
    ascending IEEE total order for floats (int32 for floats up to 32 bits,
    int64 for f64) and ascending value for integers (int64)."""
    if values.is_floating_point():
        if values.dtype == torch.float64:
            b = values.contiguous().view(torch.int64)
            return b ^ ((b >> 63) & _I64_MAX)
        b = values.to(torch.float32).contiguous().view(torch.int32)
        return b ^ ((b >> 31) & _I32_MAX)
    return values.to(torch.int64)


_WIDE_UNSIGNED = (torch.uint16, torch.uint32)


def gather(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather`` along the last dim; uint16 and uint32, which
    PyTorch cannot gather, go through int64 and back (exact)."""
    if values.dtype in _WIDE_UNSIGNED:
        return torch.gather(values.to(torch.int64), -1, idx).to(values.dtype)
    return torch.gather(values, -1, idx)


def topk(values: torch.Tensor, k: int, largest: bool = True
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` (``largest=True``) or ``lax.top_k`` of the order-
    reversed values (``largest=False``) along the last dim: ``(values,
    int64 positions)``, best-first; values are gathered, bit-exact."""
    key = sortable_key(values)
    idx = torch.sort(~key if largest else key, dim=-1,
                     stable=True).indices[..., :k]
    return gather(values, idx), idx
