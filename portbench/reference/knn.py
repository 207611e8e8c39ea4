"""Exact k nearest neighbours under squared L2, in plain PyTorch.

Distances are ranked in the expanded form ``|q|^2 + |x|^2 - 2 q.x`` (a
float32 product, TF32 off) in blocks of queries; the best ``k + margin``
are then worked out again as ``sum((q - x)^2)`` and sorted, so a near
tie is settled by the direct form and not by the expansion's rounding.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from portbench.reference import exact_f32


def direct_sq_l2(queries: torch.Tensor, rows: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """``sum((q - rows[id])^2)`` for each query and each of its ids
    [q, j]; +inf where an id is out of range."""
    n = rows.shape[0]
    ok = (ids >= 0) & (ids < n)
    picked = rows[ids.long().clamp(0, n - 1)]            # [q, j, d]
    diff = queries[:, None, :].to(torch.float32) - picked
    d = (diff * diff).sum(-1)
    return torch.where(ok, d, torch.full_like(d, float("inf")))


def exact_topk(db: torch.Tensor, queries: torch.Tensor, k: int, *,
               mask: Optional[Callable[[int, int], torch.Tensor]] = None,
               block: int = 512, margin: int = 16):
    """``(dist [q, k], ids [q, k])`` nearest first. ``mask(lo, hi)``, if
    given, returns a [hi - lo, n] bool of the rows each query of the
    block may take; the others are out (+inf, id -1)."""
    db = db.to(torch.float32)
    queries = queries.to(torch.float32)
    take = min(k + margin, db.shape[0])
    out_d, out_i = [], []
    with exact_f32():
        dbn = (db * db).sum(1)
        for lo in range(0, queries.shape[0], block):
            q = queries[lo:lo + block]
            d = (q * q).sum(1)[:, None] + dbn[None, :] - 2.0 * (q @ db.T)
            if mask is not None:
                d.masked_fill_(~mask(lo, lo + q.shape[0]), float("inf"))
            v, i = torch.topk(d, take, dim=1, largest=False)
            del d
            exact = direct_sq_l2(q, db, i)
            exact = torch.where(torch.isinf(v), v, exact)
            exact, order = torch.sort(exact, dim=1, stable=True)
            i = torch.gather(i, 1, order)
            i = torch.where(torch.isinf(exact), torch.full_like(i, -1), i)
            out_d.append(exact[:, :k])
            out_i.append(i[:, :k])
    return torch.cat(out_d), torch.cat(out_i)


def nearest_two(x: torch.Tensor, centres: torch.Tensor, block: int = 65536):
    """Each row's two nearest centres: ``(d1, label, d2)`` with ``d1``
    worked out again in the direct form."""
    d1s, labs, d2s = [], [], []
    with exact_f32():
        cn = (centres * centres).sum(1)
        for lo in range(0, x.shape[0], block):
            xb = x[lo:lo + block]
            d = (xb * xb).sum(1)[:, None] + cn[None, :] - 2.0 * (xb @ centres.T)
            v, i = torch.topk(d, min(2, centres.shape[0]), dim=1,
                              largest=False)
            labs.append(i[:, 0])
            d1s.append(direct_sq_l2(xb, centres, i[:, :1])[:, 0])
            d2s.append(direct_sq_l2(xb, centres, i[:, -1:])[:, 0]
                       if centres.shape[0] > 1 else torch.full_like(
                           v[:, 0], float("inf")))
    return torch.cat(d1s), torch.cat(labs), torch.cat(d2s)
