"""Rank-1 Cholesky update (counterpart of ``raft_tpu/linalg/cholesky.py``).

Given L of A[:n-1, :n-1] and the new column A[:, n-1], the new row of L
is a triangular solve and the new pivot ``sqrt(a[n-1] - xᵀx)``, floored
at ``eps`` when ``eps > 0``. With ``eps = 0`` a negative pivot gives NaN
(guard mode 'off'); the reference's 'check' and 'recover' pivot guards
come with ROADMAP.md, queue A item 13b (they raise
``NotImplementedError`` here).
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.guards import resolve_guard_mode
from raft_tpu_torch.core.operators import exact_sqrt
from raft_tpu_torch.core.resources import as_tensor


def cholesky_r1_update(res, L, A_new_col, n: int, lower: bool = True,
                       eps: float = 0.0,
                       guard_mode: Optional[str] = None):
    """Extend a Cholesky factor by one rank.

    ``L``: [n, n] whose leading (n-1) x (n-1) block is the previous
    factor (lower; upper with ``lower=False``); only that block is read.
    ``A_new_col``: the new column A[:n, n-1]. Returns the updated [n, n]
    factor, lower or upper as ``lower``."""
    resolve_guard_mode(guard_mode)
    L = as_tensor(L, res)
    a = as_tensor(A_new_col, res).ravel().to(L.dtype)
    if not lower:
        L = L.T
    out = L.clone()
    if n == 1:
        out[0, 0] = exact_sqrt(torch.maximum(
            a[0], torch.as_tensor(eps if eps > 0 else a[0], dtype=L.dtype,
                                  device=L.device)))
        return out if lower else out.T
    Lsub = L[: n - 1, : n - 1]
    x = torch.linalg.solve_triangular(Lsub, a[: n - 1, None],
                                      upper=False)[:, 0]
    d_sq = a[n - 1] - torch.dot(x, x)
    if eps > 0:
        d_sq = torch.clamp_min(d_sq, eps)
    out[n - 1, : n - 1] = x
    out[n - 1, n - 1] = exact_sqrt(d_sq)
    out[: n - 1, n - 1] = 0
    return out if lower else out.T
