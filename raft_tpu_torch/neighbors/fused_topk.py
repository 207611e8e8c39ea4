"""Fused distance + running top-k: the kNN path that never materialises
the distance matrix (counterpart of ``raft_tpu/neighbors/fused_topk.py``).

CUDA kernel: ``csrc/fused_topk.cu`` (the reference's ``_topk_kernel`` /
``_topk_kernel_split``: a distance tile plus the bound-gated sorted
insertion of ``epilogue.insert_drain``), beside its plain version
:func:`_fused_topk_plain`. Operands follow the precision tier as in
``linalg/contractions.py``; :data:`ROUTE` names the tile at each tier.
The result is each query's k smallest ``(distance, column)`` pairs,
best-first; a NaN or +inf distance never enters, and empty slots are
``(+inf, 0)``. The kernel cuts the database into splits
(:func:`_split_plan`) and merges each row's split lists; the keys are
exact, so no result depends on the split count.

The reference's tune-only 1-NN floor probe, :func:`_minonly_probe`, is
here too: the same distance tile and grid with a running min in place of
the insertion (CUDA kernel ``csrc/minonly.cu``, plain version
:func:`_minonly_plain`), so the gap between the two kernels is the
selection's price. It is not a user API.
"""

from __future__ import annotations

import functools
from collections import namedtuple
from typing import Optional

import torch

from raft_tpu_torch import kernels
from raft_tpu_torch.linalg import contractions as tc
from raft_tpu_torch.matrix.epilogue import (MAX_K, insert_drain_plain,
                                            masked_fold, resolve_tn_sw,
                                            row_min_arg)
from raft_tpu_torch.util.math import cdiv, round_up_to_multiple
from raft_tpu_torch.util.precision import current_mode, with_matmul_precision

# Cross-product tile of csrc/fused_topk.cu and csrc/minonly.cu at each
# tier: the tensor-core tile of csrc/wgmma_tile.cuh in its split walk, or
# csrc/common.cuh's CUDA-core FMA tile (no exact f32 tensor-core product
# exists for 'highest').
ROUTE = {"default": "wgmma", "high": "wgmma", "highest": "fma"}

# The wgmma route's plan (:func:`_split_plan`): one persistent block a
# multiprocessor of the card over work units (128-row query tile,
# database split). Each split refills every row's list, about
# k (1 + ln(cols / k)) insertions a row, so the plan takes the fewest
# splits whose busiest block walks at most PLAN_SLACK more column tiles
# than under the best split count (linalg/contractions._plan_splits and
# PLAN_SLACK, which the fused argmin's plan shares). A row's split lists
# are merged in MERGE_BYTES of shared memory.
MERGE_BYTES = 200 * 1024

# The FMA route's grid ('highest'): query tiles x database splits, aiming
# at TARGET_BLOCKS blocks, at most MAX_SPLITS splits; fixed by the shapes
# and never by the card. On a 132-SM H100 that is four waves of two
# blocks an SM: the kernel holds 127 registers a thread and 79-92 KB of
# shared memory at k = 64-256, so two blocks fit an SM.
TARGET_BLOCKS = 1056
MAX_SPLITS = 64

SplitPlan = namedtuple("SplitPlan", "splits tiles_per_split units grid "
                       "scratch_bytes")


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


@functools.lru_cache(maxsize=256)
def _split_plan(m: int, n: int, k: int, sms: int,
                splits: Optional[int] = None) -> SplitPlan:
    """The wgmma route's plan for m queries, n database rows and k
    results (1 for the probe) on a card of ``sms`` multiprocessors: a
    pure function of its arguments.

    - ``splits``, ``tiles_per_split``: the database's 128-column tiles
      cut into splits, none empty; ``splits`` given (a test's choice) or
      the fewest whose busiest block walks at most tc.PLAN_SLACK more tiles
      than the best count's, among 1 .. sms;
    - ``units``: query tiles x splits, the walk's work units; ``grid``:
      its persistent blocks, one a multiprocessor, at most one a unit;
    - ``scratch_bytes``: the split lists, [splits][m][k] 8-byte keys."""
    if min(m, n, k, sms) < 1 or (splits is not None and splits < 1):
        raise ValueError(f"bad split plan arguments m={m} n={n} k={k} "
                         f"sms={sms} splits={splits}")
    row_tiles, n_tiles = cdiv(m, tc.TILE_M), cdiv(n, tc.TILE_N)
    splits, tps = tc._plan_splits(row_tiles, n_tiles, sms,
                                  min(n_tiles, MERGE_BYTES // (8 * k)),
                                  splits)
    units = row_tiles * splits
    return SplitPlan(splits, tps, units, min(sms, units), 8 * splits * m * k)


def _fma_splits(m: int, n: int, splits: Optional[int] = None) -> int:
    """Database splits of the FMA route's grid; no split is empty."""
    n_tiles = cdiv(n, tc.TILE_N)
    if splits is None:
        splits = max(1, min(n_tiles, cdiv(TARGET_BLOCKS, cdiv(m, tc.TILE_M)),
                            MAX_SPLITS))
    return tc._whole_splits(n_tiles, min(splits, n_tiles))[0]


def _launch_plan(tier: str, xs, ys, m: int, n: int, kd: int, k: int,
                 splits: Optional[int]):
    """``(xs, ys, kd, splits, grid)`` of a launch of fused_topk.cu or
    minonly.cu on the route :data:`ROUTE` names: the wgmma route's bf16
    operands (:func:`~raft_tpu_torch.linalg.contractions._wgmma_operands`)
    and split plan, or the FMA route's operands and splits (grid 0: its
    grid is query tiles x splits)."""
    if ROUTE[tier] == "fma":
        return xs, ys, kd, _fma_splits(m, n, splits), 0
    sms = torch.cuda.get_device_properties(xs.v0.device).multi_processor_count
    plan = _split_plan(m, n, k, sms, splits)
    xs, ys, kd = tc._wgmma_operands(tier, xs, ys, m, n, kd)
    return xs, ys, kd, plan.splits, plan.grid


def _fused_topk(tier: str, metric: str, xs, ys, m: int, n: int, kd: int,
                k: int, splits: Optional[int] = None):
    """``(vals f32 [m, k], idx int32 [m, k])``: csrc/fused_topk.cu on
    CUDA, the plain version on the CPU. ``splits``: a test's database
    split count (default: the route's plan); no result depends on it."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"need 1 <= k <= {MAX_K}, got {k}")
    if tc._on_cpu(xs, ys):
        return _fused_topk_plain(tier, metric, xs, ys, m, n, kd, k)
    tc._check_side(xs, tier, m, kd, "x")
    tc._check_side(ys, tier, n, kd, "y")
    dev = xs.v0.device
    xs, ys, kd, splits, grid = _launch_plan(tier, xs, ys, m, n, kd, k,
                                            splits)
    lists = torch.empty((splits, m, k), dtype=torch.int64, device=dev)
    vals = torch.empty((m, k), dtype=torch.float32, device=dev)
    idx = torch.empty((m, k), dtype=torch.int32, device=dev)
    kernels.launch("fused_topk", dev, tc._TIER_CODE[tier],
                   tc._METRIC_CODE[metric], *tc._operand_args(xs, ys), m, n,
                   kd, k, splits, grid, lists.data_ptr(), vals.data_ptr(),
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


def _minonly(tier: str, xs, ys, m: int, n: int, kd: int, tn: int = 1024,
             splits: Optional[int] = None):
    """``(vals f32 [m], idx int32 [m])``: csrc/minonly.cu on CUDA, on
    fused_topk.cu's route and plan (k = 1); the plain version on the
    CPU. ``splits`` as :func:`_fused_topk`'s."""
    if tc._on_cpu(xs, ys):
        return _minonly_plain(tier, xs, ys, m, n, kd, tn)
    tc._check_side(xs, tier, m, kd, "x")
    tc._check_side(ys, tier, n, kd, "y")
    dev = xs.v0.device
    xs, ys, kd, splits, grid = _launch_plan(tier, xs, ys, m, n, kd, 1,
                                            splits)
    part_v = torch.empty((splits, m), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits, m), dtype=torch.int32, device=dev)
    vals = torch.empty((m,), dtype=torch.float32, device=dev)
    idx = torch.empty((m,), dtype=torch.int32, device=dev)
    kernels.launch("minonly", dev, tc._TIER_CODE[tier],
                   *tc._operand_args(xs, ys), m, n, kd, splits, grid,
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
