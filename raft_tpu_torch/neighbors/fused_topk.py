"""Fused distance + running top-k: the kNN path that never materialises
the distance matrix (counterpart of ``raft_tpu/neighbors/fused_topk.py``).

CUDA kernel: ``csrc/fused_topk.cu`` (the reference's ``_topk_kernel`` /
``_topk_kernel_split``: a distance tile plus the bound-gated sorted
insertion of ``epilogue.insert_drain``), beside its plain version
:func:`_fused_topk_plain`. Operands follow the precision tier as in
``linalg/contractions.py``. The result is each query's k smallest
``(distance, column)`` pairs, best-first; a NaN or +inf distance never
enters, and empty slots are ``(+inf, 0)``.

The reference's tune-only 1-NN floor probe, :func:`_minonly_probe`, is
here too: the same distance tile and grid with a running min in place of
the insertion (CUDA kernel ``csrc/minonly.cu``, plain version
:func:`_minonly_plain`), so the gap between the two kernels is the
selection's price. It is not a user API.
"""

from __future__ import annotations

import torch

from raft_tpu_torch import kernels
from raft_tpu_torch.linalg import contractions as tc
from raft_tpu_torch.matrix.epilogue import (MAX_K, insert_drain_plain,
                                            masked_fold, resolve_tn_sw,
                                            row_min_arg)
from raft_tpu_torch.util.math import cdiv, round_up_to_multiple
from raft_tpu_torch.util.precision import current_mode, with_matmul_precision

# Blocks the kernel aims for (query tiles x database splits): eight waves
# of one block per SM on a 132-SM H100 (at tier 'high' a block holds 179
# registers a thread, so one fits an SM), fixed by the shapes and never
# by the card. The result does not depend on the split count.
TARGET_BLOCKS = 1056
MAX_SPLITS = 64


def supports(k: int) -> bool:
    """The fused path keeps a 256-wide sorted best per query row."""
    return 1 <= k <= MAX_K


def epilogue(k: int) -> str:
    """Which selection epilogue serves this k on the kNN hot path:
    ``"insert"`` (this kernel, k <= 256) or ``"radix"``."""
    return "insert" if supports(k) else "radix"


def _fused_topk_plain(tier: str, metric: str, xs, ys, m: int, n: int,
                      kd: int, k: int):
    """The distance matrix at the tier, then the drain's contract
    (:func:`~raft_tpu_torch.matrix.epilogue.insert_drain_plain`)."""
    return insert_drain_plain(tc._pairwise_plain(tier, metric, xs, ys, m, n,
                                                 kd), k)


def _splits(m: int, n: int) -> int:
    """Database splits of the kernel's grid; no split is empty."""
    n_tiles = cdiv(n, tc.TILE_N)
    splits = max(1, min(n_tiles, cdiv(TARGET_BLOCKS, cdiv(m, tc.TILE_M)),
                        MAX_SPLITS))
    return cdiv(n_tiles, cdiv(n_tiles, splits))


def _fused_topk(tier: str, metric: str, xs, ys, m: int, n: int, kd: int,
                k: int):
    """``(vals f32 [m, k], idx int32 [m, k])``: csrc/fused_topk.cu on
    CUDA, the plain version on the CPU."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"need 1 <= k <= {MAX_K}, got {k}")
    if tc._on_cpu(xs, ys):
        return _fused_topk_plain(tier, metric, xs, ys, m, n, kd, k)
    tc._check_side(xs, tier, m, kd, "x")
    tc._check_side(ys, tier, n, kd, "y")
    dev = xs.v0.device
    splits = _splits(m, n)
    lists = torch.empty((splits, m, k), dtype=torch.int64, device=dev)
    vals = torch.empty((m, k), dtype=torch.float32, device=dev)
    idx = torch.empty((m, k), dtype=torch.int32, device=dev)
    kernels.launch("fused_topk", dev, tc._TIER_CODE[tier],
                   tc._METRIC_CODE[metric], *tc._operand_args(xs, ys), m, n,
                   kd, k, splits, lists.data_ptr(), vals.data_ptr(),
                   idx.data_ptr())
    return vals, idx


@with_matmul_precision
def knn_fused(queries, db, k: int, metric: str = "l2", tm: int = 256,
              tn: int = 1024, sw=None):
    """Fused-kernel kNN: ``(vals [q, k], idx [q, k])``, nearest first.

    Inputs are f32 (cast by the caller); ``metric`` is the kernel
    vocabulary ('l2' squared, 'cosine', 'inner'). ``tm``, ``tn`` and
    ``sw`` are the reference's TPU tile knobs: ``tn`` and ``sw`` are
    validated as there (``resolve_tn_sw``), and none of them chooses
    anything in the kernel; the reference's output, too, is the same for
    any of them.
    CUDA kernel: ``csrc/fused_topk.cu``."""
    if metric not in tc._METRIC_CODE:
        raise ValueError(f"unknown metric {metric!r}")
    x, y = tc._pair(queries, db)
    q, d = x.shape
    n = y.shape[0]
    if not supports(k):
        raise ValueError(f"knn_fused: need 1 <= k <= {MAX_K}, got {k}")
    resolve_tn_sw(tn, sw, n)
    tier = current_mode()
    return _fused_topk(tier, metric, tc._side(x, tier), tc._side(y, tier),
                       q, n, d, k)


# ---------------------------------------------------------------------------
# the 1-NN floor probe (tune-only): csrc/minonly.cu
# ---------------------------------------------------------------------------


def _minonly_plain(tier: str, xs, ys, m: int, n: int, kd: int,
                   tn: int = 1024):
    """The probe's function as the reference's ``_minonly_body`` folds it:
    the l2 distances at the tier, then a running (min, argmin) over
    ``tn``-wide column tiles from ``(+inf, 0)``, a tile's first minimum
    taken only when strictly smaller (so the smaller column wins ties).
    A NaN distance never wins (the port's rule, see ROADMAP.md queue C)."""
    d = tc._pairwise_plain(tier, "l2", xs, ys, m, n, kd)
    d = torch.where(torch.isnan(d), float("inf"), d)
    state = None
    for j0 in range(0, n, tn):
        tile = d[:, j0:j0 + tn]
        col = torch.arange(j0, j0 + tile.shape[1], dtype=torch.int32,
                           device=d.device)
        state = masked_fold(state, *row_min_arg(tile, col), 0)
    return state[0][:, 0], state[1][:, 0]


def _minonly(tier: str, xs, ys, m: int, n: int, kd: int, tn: int = 1024):
    """``(vals f32 [m], idx int32 [m])``: csrc/minonly.cu on CUDA, on
    fused_topk.cu's grid; the plain version on the CPU."""
    if tc._on_cpu(xs, ys):
        return _minonly_plain(tier, xs, ys, m, n, kd, tn)
    tc._check_side(xs, tier, m, kd, "x")
    tc._check_side(ys, tier, n, kd, "y")
    dev = xs.v0.device
    splits = _splits(m, n)
    part_v = torch.empty((splits, m), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits, m), dtype=torch.int32, device=dev)
    vals = torch.empty((m,), dtype=torch.float32, device=dev)
    idx = torch.empty((m,), dtype=torch.int32, device=dev)
    kernels.launch("minonly", dev, tc._TIER_CODE[tier],
                   *tc._operand_args(xs, ys), m, n, kd, splits,
                   part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
                   idx.data_ptr())
    return vals, idx


@with_matmul_precision
def _minonly_probe(queries, db, tm: int = 256, tn: int = 1024):
    """Tune-only probe: 1-NN under squared l2 by a running min at the fused
    kernel's grid, ``(vals [q], idx [q])``, with :func:`knn_fused`'s tier
    dispatch (pre-split operands at 'high'), so the floor it measures
    prices the same distance pipeline. Not a user API: kNN callers want k
    results.

    ``tm`` and ``tn`` are the reference's TPU tiles: ``tn`` is clamped as
    there and sets the plain version's fold width; neither chooses
    anything in the kernel, and the result is the same for any of them.
    CUDA kernel: ``csrc/minonly.cu``."""
    x, y = tc._pair(queries, db)
    q, d = x.shape
    n = y.shape[0]
    del tm
    tn = max(128, min(tn - tn % 128, round_up_to_multiple(n, 128)))
    tier = current_mode()
    return _minonly(tier, tc._side(x, tier), tc._side(y, tier), q, n, d, tn)
