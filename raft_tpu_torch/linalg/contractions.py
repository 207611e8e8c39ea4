"""The contraction engine of the port (counterpart of
``raft_tpu/linalg/contractions.py``): pairwise distance tiles, fused
distance + argmin, and the fused Lloyd pass.

Three CUDA kernels carry it, each beside its plain PyTorch version:

============================  ==========================  ================
entry points                  CUDA kernel                 plain version
============================  ==========================  ================
pairwise_pallas,              csrc/pairwise_tile.cu       _pairwise_plain
pairwise_l2_pallas
fused_argmin_pallas,          csrc/fused_argmin.cu        _argmin_plain
fused_l2_argmin_pallas
fused_lloyd_pallas,           csrc/fused_lloyd.cu         _lloyd_plain
fused_lloyd_prepared
pairwise_unexpanded_pallas    csrc/unexpanded_tile.cu     unexpanded_ref
============================  ==========================  ================

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
plain version, which computes the same function with the same tie, NaN
and padding rules. There is no fallback from the kernel to the plain
version. A non-tensor input (a numpy array) goes to ``cuda:0``, which
raises without CUDA.

Operands follow the precision tier in effect (``util/precision.py``):
at ``'high'`` each f32 side is split once into bf16 hi/lo halves plus
f32 squared row norms (:func:`_split_side`, plain torch outside the
kernel, as in the reference package); at ``'default'`` and ``'highest'``
the kernel reads f32 rows and the norms are computed the same way.
Inputs of any float dtype are taken as f32, except by the unexpanded
family (:func:`pairwise_unexpanded_pallas`), which keeps f64 as f64.

The TPU tile knobs of the reference functions (``tm``, ``tn``,
``packed``, ``counts_mxu``) have no counterpart: the CUDA kernels use
fixed 128 x 128 tiles that fit Hopper's 227 KB of shared memory a block
and mask ragged edges, so the reference's VMEM planner and its fallback
path are gone. What is left to plan is the Lloyd pass's argmin grid and
scratch (:func:`_lloyd_plan`), the fused argmin's walk (:func:`_argmin_plan`)
and, for the tensor-core route at ``'default'`` and ``'high'``
(:data:`PAIRWISE_ROUTE`, :data:`ARGMIN_ROUTE`, the Lloyd pass's argmin
alike), the bf16 operand rows with their depth padded by zero columns to
a multiple of 8 (:func:`_wgmma_operands`).
"""

from __future__ import annotations

import struct
from collections import namedtuple
from typing import Optional, Tuple

import torch

from raft_tpu_torch import kernels
from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.matrix.epilogue import assign_onehot, iota_argmin
from raft_tpu_torch.util.math import cdiv
from raft_tpu_torch.util.precision import current_mode, with_matmul_precision

_TIER_CODE = {"default": 0, "high": 1, "highest": 2}
_METRIC_CODE = {"l2": 0, "cosine": 1, "inner": 2}
_COSINE_EPS = 1e-30

# Row and column tiles of the kernels (csrc/common.cuh BM, BN).
TILE_M = 128
TILE_N = 128

# Tile of csrc/pairwise_tile.cu at each tier: the tensor-core tile of
# csrc/wgmma_tile.cuh, or csrc/common.cuh's CUDA-core FMA tile (no exact
# f32 tensor-core product exists for 'highest').
PAIRWISE_ROUTE = {"default": "wgmma", "high": "wgmma", "highest": "fma"}
# Tile of csrc/fused_argmin.cu at each tier, as PAIRWISE_ROUTE.
ARGMIN_ROUTE = {"default": "wgmma", "high": "wgmma", "highest": "fma"}
# The wgmma route's operand rows: depth and row stride a multiple of 8
# bf16 (16 bytes), so every 16-byte copy of a row is whole.
WGMMA_DEPTH = 8
# The wgmma split walk's planning (:func:`_plan_splits`, shared by the
# fused argmin and neighbors/fused_topk.py): the fewest splits whose
# busiest block walks at most PLAN_SLACK more column tiles than under the
# best split count.
PLAN_SLACK = 1 / 16

# The Lloyd pass (csrc/fused_lloyd.cu): an argmin on a persistent grid of
# one block a multiprocessor (132 on an H100 SXM), then sums from the
# labels alone, so no result depends on the grid. The sums group the rows
# by label, a warp a chunk of at least LLOYD_ROW_CHUNK rows, the chunk
# doubled until the (chunk, cluster) counters fit LLOYD_HIST_ENTRIES; a
# warp then sums at most LLOYD_SEG of a cluster's sorted rows.
LLOYD_SMS = 132
LLOYD_ROW_CHUNK = 1024
LLOYD_HIST_ENTRIES = 1 << 22
LLOYD_SEG = 256

# One side of a contraction in the tier's operand format: v0 (f32 rows,
# or the bf16 hi halves at 'high'), v1 (the bf16 lo halves, else None),
# norms (f32 squared row norms, 1-D).
Side = namedtuple("Side", "v0 v1 norms")


# ---------------------------------------------------------------------------
# operand preparation (plain torch, outside the kernels)
# ---------------------------------------------------------------------------


def _as_f32(a) -> torch.Tensor:
    a = as_tensor(a)
    if not a.is_floating_point():
        raise TypeError(f"expected a floating tensor, got {a.dtype}")
    return a.to(torch.float32).contiguous()


def _round_to_bf16_f32(a: torch.Tensor) -> torch.Tensor:
    """Round f32 to its nearest bf16 value (half to even), kept in f32,
    by the integer arithmetic of the reference package's
    ``_round_to_bf16_f32`` — bit for bit, NaN inputs included (their hi
    half is garbage; the lo half ``a - hi`` is NaN)."""
    u = a.contiguous().view(torch.int32)
    u = u + 0x7FFF + ((u >> 16) & 1)          # int32 wraps like uint32
    return (u & -65536).view(torch.float32)   # & 0xFFFF0000


def _split_hi_lo(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi, lo) bf16 halves with a ~= hi + lo."""
    hi_f = _round_to_bf16_f32(a)
    return hi_f.to(torch.bfloat16), (a - hi_f).to(torch.bfloat16)


def _sq_norms(a: torch.Tensor) -> torch.Tensor:
    """Row squared norms in f32."""
    return torch.sum(a * a, dim=1)


def _split_side(a: torch.Tensor):
    """The tier-'high' operand format of one side: ``(hi, lo, norms)``
    with norms laid out ``(1, rows)`` as in the reference package."""
    hi, lo = _split_hi_lo(a)
    return hi, lo, _sq_norms(a)[None, :]


def _side(a: torch.Tensor, tier: str) -> Side:
    if tier == "high":
        hi, lo, norms = _split_side(a)
        return Side(hi, lo, norms.reshape(-1))
    return Side(a, None, _sq_norms(a))


def _bf16_values(a: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to bf16 (half to even), as f32."""
    return a.to(torch.bfloat16).to(torch.float32)


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic in PyTorch; CPU tensors run these)
# ---------------------------------------------------------------------------


def _rows(side: Side, rows: int, k: int):
    v1 = None if side.v1 is None else side.v1[:rows, :k]
    return side.v0[:rows, :k], v1, side.norms[:rows]


def _cross_plain(tier: str, x0, x1, y0, y1) -> torch.Tensor:
    """x·yᵀ at the tier: one bf16 pass, bf16x3 from the halves
    (``hi·hi + hi·lo + lo·hi``), or f32."""
    if tier == "high":
        xh, xl, yh, yl = (t.to(torch.float32) for t in (x0, x1, y0, y1))
        return xh @ yh.T + xh @ yl.T + xl @ yh.T
    if tier == "default":
        return _bf16_values(x0) @ _bf16_values(y0).T
    return x0 @ y0.T


def _metric_plain(metric: str, cross, xn, yn) -> torch.Tensor:
    if metric == "l2":
        return xn[:, None] - 2.0 * cross + yn[None, :]
    if metric == "cosine":
        return 1.0 - cross / (torch.sqrt(xn + _COSINE_EPS)[:, None]
                              * torch.sqrt(yn + _COSINE_EPS)[None, :])
    if metric == "inner":
        return -cross
    raise ValueError(f"unknown metric {metric!r}")


def _pairwise_plain(tier: str, metric: str, xs: Side, ys: Side,
                    m: int, n: int, k: int) -> torch.Tensor:
    x0, x1, xn = _rows(xs, m, k)
    y0, y1, yn = _rows(ys, n, k)
    return _metric_plain(metric, _cross_plain(tier, x0, x1, y0, y1), xn, yn)


def _argmin_plain(tier: str, metric: str, xs: Side, ys: Side,
                  m: int, n: int, k: int):
    d = _pairwise_plain(tier, metric, xs, ys, m, n, k)
    _, minval, arg = iota_argmin(d, n)
    return minval[:, 0], arg[:, 0]


def _lloyd_plain(tier: str, xs: Side, ys: Side, m: int, n: int, k: int):
    x0, x1, _ = _rows(xs, m, k)
    d = _pairwise_plain(tier, "l2", xs, ys, m, n, k)
    col, minval, arg = iota_argmin(d, n, finite=True)
    oh = assign_onehot(col, arg).to(torch.float32)
    if tier == "high":
        sums = oh.T @ x0.to(torch.float32) + oh.T @ x1.to(torch.float32)
    elif tier == "default":
        sums = oh.T @ _bf16_values(x0)
    else:
        sums = oh.T @ x0
    return (sums, torch.sum(oh, dim=0), torch.clamp_min(minval[:, 0], 0.0),
            arg[:, 0])


# ---------------------------------------------------------------------------
# kernel wrappers: CPU tensors take the plain version, CUDA tensors the
# kernel
# ---------------------------------------------------------------------------


def _on_cpu(*sides: Side) -> bool:
    devices = {s.v0.device for s in sides}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def _check_side(side: Side, tier: str, rows: int, k: int, name: str):
    want = torch.bfloat16 if tier == "high" else torch.float32
    v0, v1, norms = side
    parts = [v0] if tier != "high" else [v0, v1]
    for t in parts:
        if t is None or t.dtype != want or t.dim() != 2:
            raise TypeError(f"{name}: tier {tier!r} takes 2-D {want} rows")
        if t.shape[0] < rows or t.shape[1] < k or t.stride(1) != 1:
            raise ValueError(f"{name}: rows must be [>= {rows}, >= {k}] "
                             f"with unit column stride, got {tuple(t.shape)}"
                             f" strides {t.stride()}")
    if v1 is not None and tier == "high" and v1.stride() != v0.stride():
        raise ValueError(f"{name}: hi and lo halves differ in layout")
    if (norms.dtype != torch.float32 or norms.dim() != 1
            or not norms.is_contiguous() or norms.shape[0] < rows):
        raise ValueError(f"{name}: norms must be contiguous f32 [>= {rows}]")
    if any(t.device != v0.device for t in parts + [norms]):
        raise ValueError(f"{name}: operands on different devices")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _operand_args(xs: Side, ys: Side):
    return (_ptr(xs.v0), _ptr(xs.v1), _ptr(xs.norms), xs.v0.stride(0),
            _ptr(ys.v0), _ptr(ys.v1), _ptr(ys.norms), ys.v0.stride(0))


def _wgmma_side(side: Side, tier: str, rows: int, k: int, kp: int,
                zero_tail: bool = False) -> Side:
    """Rows ``[:rows, :k]`` of one side in the wgmma route's format: bf16
    (the f32 rows of 'default' rounded half to even; the halves of 'high'
    as they are), copied with zero columns up to depth ``kp`` where the
    depth, a row stride or a base is not 16-byte aligned, else the same
    memory. ``zero_tail``: the caller vouches that columns ``k .. kp``
    of the side, where it has them, are zeros, so they serve as the
    padding."""
    parts = [side.v0] if tier == "default" else [side.v0, side.v1]
    width = kp if zero_tail and side.v0.shape[1] >= kp else k
    parts = [p[:rows, :width].to(torch.bfloat16) for p in parts]
    if kp != width or any(p.stride(0) % WGMMA_DEPTH or p.data_ptr() % 16
                          for p in parts):
        padded = []
        for p in parts:
            q = p.new_zeros((rows, kp))
            q[:, :k] = p
            padded.append(q)
        parts = padded
    return Side(parts[0], parts[1] if len(parts) == 2 else None, side.norms)


def _wgmma_operands(tier: str, xs: Side, ys: Side, m: int, n: int, k: int,
                    x_zero_tail: bool = False):
    """``(xs, ys, kp)``: both sides in the wgmma route's format and the
    padded depth. The zero columns add exact zeros, so the plain version
    gives the same result on these operands at depth kp."""
    kp = cdiv(k, WGMMA_DEPTH) * WGMMA_DEPTH
    return (_wgmma_side(xs, tier, m, k, kp, x_zero_tail),
            _wgmma_side(ys, tier, n, k, kp), kp)


def _pairwise_tile(tier: str, metric: str, xs: Side, ys: Side,
                   m: int, n: int, k: int) -> torch.Tensor:
    """Distance matrix [m, n]: csrc/pairwise_tile.cu on CUDA, on the tile
    :data:`PAIRWISE_ROUTE` names for the tier."""
    if _on_cpu(xs, ys):
        return _pairwise_plain(tier, metric, xs, ys, m, n, k)
    _check_side(xs, tier, m, k, "x")
    _check_side(ys, tier, n, k, "y")
    dev = xs.v0.device
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if PAIRWISE_ROUTE[tier] == "wgmma":
        xs, ys, k = _wgmma_operands(tier, xs, ys, m, n, k)
    kernels.launch("pairwise_tile", dev, _TIER_CODE[tier],
                   _METRIC_CODE[metric], *_operand_args(xs, ys),
                   out.data_ptr(), m, n, k)
    return out


def _whole_splits(n_tiles: int, splits: int):
    """``(splits, tiles a split)`` with ``splits`` cut down until no
    split is empty (the last may be shorter)."""
    tps = cdiv(n_tiles, splits)
    return cdiv(n_tiles, tps), tps


def _plan_splits(row_tiles: int, n_tiles: int, sms: int, most: int,
                 splits: Optional[int] = None):
    """``(splits, tiles a split)`` of a wgmma split walk over
    ``row_tiles`` x ``n_tiles`` tiles on ``sms`` persistent blocks:
    ``splits`` given (a test's choice, at most ``most``) or the fewest,
    among 1 .. min(most, sms), whose busiest block walks at most
    PLAN_SLACK more column tiles than the best count's; none empty."""
    def walk(s):
        s, tps = _whole_splits(n_tiles, s)
        return cdiv(row_tiles * s, sms) * tps

    if splits is None:
        tried = range(1, min(most, sms) + 1)
        best = min(walk(s) for s in tried)
        splits = next(s for s in tried if walk(s) <= best * (1 + PLAN_SLACK))
    return _whole_splits(n_tiles, min(splits, most))


ArgminPlan = namedtuple("ArgminPlan", "walk fold splits tiles_per_split "
                        "units grid scratch_bytes")


def _argmin_plan(m: int, n: int, sms: int = LLOYD_SMS,
                 blocks: Optional[int] = None,
                 splits: Optional[int] = None) -> ArgminPlan:
    """The fused argmin's wgmma plan for m rows against n columns on
    ``sms`` multiprocessors, from the shapes alone:

    - ``splits``, ``tiles_per_split``: the 128-column tiles cut into
      splits, none empty, by :func:`_plan_splits` (``splits`` a test's
      choice); one split is the row-owning ``walk`` ``"row"`` (X has
      enough row tiles to fill the card), more the ``"split"`` walk;
    - ``fold``: ``"flat"`` (whole tiles folded branch-free) where n
      fills a tile, else ``"branching"`` (n < 128, one cut tile, where
      the flat form's code is slower);
    - ``units``: row tiles x splits; ``grid``: the persistent blocks,
      ``blocks`` or one a multiprocessor, at most one a unit;
    - ``scratch_bytes``: the split walk's [splits][m] partials (value and
      column), O(splits m) and never a term in grid x n x k."""
    if min(m, n, sms) < 1 or (blocks is not None and blocks < 1) or (
            splits is not None and splits < 1):
        raise ValueError(f"bad argmin plan arguments m={m} n={n} sms={sms}"
                         f" blocks={blocks} splits={splits}")
    row_tiles, n_tiles = cdiv(m, TILE_M), cdiv(n, TILE_N)
    splits, tps = _plan_splits(row_tiles, n_tiles, sms, n_tiles, splits)
    units = row_tiles * splits
    grid = min(sms if blocks is None else blocks, units)
    return ArgminPlan("row" if splits == 1 else "split",
                      "flat" if n >= TILE_N else "branching", splits, tps,
                      units, grid, 0 if splits == 1 else 8 * splits * m)


def _fused_argmin(tier: str, metric: str, xs: Side, ys: Side,
                  m: int, n: int, k: int, blocks: Optional[int] = None,
                  splits: Optional[int] = None):
    """Per-row (min, first-min argmin): csrc/fused_argmin.cu on CUDA, on
    the tile :data:`ARGMIN_ROUTE` names for the tier; the wgmma route in
    the walk of :func:`_argmin_plan`. ``blocks`` and ``splits``: a test's
    grid and split count (default: the plan's); no result depends on
    them."""
    if _on_cpu(xs, ys):
        return _argmin_plain(tier, metric, xs, ys, m, n, k)
    _check_side(xs, tier, m, k, "x")
    _check_side(ys, tier, n, k, "y")
    dev = xs.v0.device
    f32 = dict(dtype=torch.float32, device=dev)
    val = torch.empty((m,), **f32)
    idx = torch.empty((m,), dtype=torch.int32, device=dev)
    nsplit, flat, grid, part_v, part_i = 1, 1, 0, None, None
    if ARGMIN_ROUTE[tier] == "wgmma":
        plan = _argmin_plan(m, n, torch.cuda.get_device_properties(
            dev).multi_processor_count, blocks, splits)
        xs, ys, k = _wgmma_operands(tier, xs, ys, m, n, k)
        nsplit, flat, grid = plan.splits, int(plan.fold == "flat"), plan.grid
        if nsplit > 1:
            part_v = torch.empty((nsplit, m), **f32)
            part_i = torch.empty((nsplit, m), dtype=torch.int32, device=dev)
    kernels.launch("fused_argmin", dev, _TIER_CODE[tier],
                   _METRIC_CODE[metric], *_operand_args(xs, ys), m, n, k,
                   nsplit, flat, grid, _ptr(part_v), _ptr(part_i),
                   val.data_ptr(), idx.data_ptr())
    return val, idx


LloydPlan = namedtuple("LloydPlan", "grid row_chunk row_chunks sum_chunks "
                       "int_words part_floats scratch_bytes")


def _lloyd_plan(m: int, n: int, k: int, sms: int = LLOYD_SMS,
                blocks: Optional[int] = None) -> LloydPlan:
    """The Lloyd pass's launch plan for m rows, n clusters, depth k:

    - ``grid``: the argmin's persistent blocks, ``blocks`` or one a
      multiprocessor, never more than the 128-row tiles; no term in n;
    - ``row_chunk``, ``row_chunks``: the rows a warp groups by label, and
      their warps;
    - ``sum_chunks``: the chunk warps of the sums, one per LLOYD_SEG rows;
    - ``int_words`` (the (chunk, cluster) counters, the clusters' totals
      and starts, the sorted row ids) and ``part_floats`` (the chunk
      warps' partial sums): the scratch, O(m + chunks (n + k)) and never a
      term in grid x n x k."""
    if min(m, n, k, sms) < 1 or (blocks is not None and blocks < 1):
        raise ValueError(f"bad Lloyd plan arguments m={m} n={n} k={k} "
                         f"sms={sms} blocks={blocks}")
    grid = min(sms if blocks is None else blocks, cdiv(m, TILE_M))
    row_chunk = LLOYD_ROW_CHUNK
    while cdiv(m, row_chunk) > 1 and cdiv(m, row_chunk) * n > \
            LLOYD_HIST_ENTRIES:
        row_chunk *= 2
    row_chunks = cdiv(m, row_chunk)
    sum_chunks = m // LLOYD_SEG + 1
    int_words = row_chunks * n + n + (n + 1) + m
    part_floats = sum_chunks * k
    return LloydPlan(grid, row_chunk, row_chunks, sum_chunks, int_words,
                     part_floats, 4 * (int_words + part_floats))


def _fused_lloyd(tier: str, xs: Side, ys: Side, m: int, n: int, k: int,
                 blocks: Optional[int] = None, x_zero_tail: bool = False):
    """(sums, counts, clamped min dist², labels): csrc/fused_lloyd.cu on
    CUDA, its argmin on ``blocks`` persistent blocks (default one a
    multiprocessor; a test passes fewer to put many row tiles on each
    block; no result depends on it). ``x_zero_tail``: as
    :func:`_wgmma_side`."""
    if _on_cpu(xs, ys):
        return _lloyd_plain(tier, xs, ys, m, n, k)
    _check_side(xs, tier, m, k, "x")
    _check_side(ys, tier, n, k, "y")
    dev = xs.v0.device
    plan = _lloyd_plan(m, n, k, torch.cuda.get_device_properties(
        dev).multi_processor_count, blocks)
    kd = k
    if tier != "highest":
        xs, ys, kd = _wgmma_operands(tier, xs, ys, m, n, k, x_zero_tail)
    f32 = dict(dtype=torch.float32, device=dev)
    sums = torch.empty((n, k), **f32)
    counts = torch.empty((n,), **f32)
    val = torch.empty((m,), **f32)
    idx = torch.empty((m,), dtype=torch.int32, device=dev)
    iscr = torch.empty((plan.int_words,), dtype=torch.int32, device=dev)
    part = torch.empty((plan.part_floats,), **f32)
    kernels.launch("fused_lloyd", dev, _TIER_CODE[tier],
                   *_operand_args(xs, ys), sums.data_ptr(),
                   counts.data_ptr(), val.data_ptr(), idx.data_ptr(),
                   iscr.data_ptr(), part.data_ptr(), plan.grid, m, n, kd, k,
                   plan.row_chunk)
    return sums, counts, val, idx


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _pair(x, y):
    x, y = _as_f32(x), _as_f32(y)
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"expected x [m, k] and y [n, k], got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if min(x.shape[0], y.shape[0], x.shape[1]) < 1:
        raise ValueError("empty operand")
    return x, y


@with_matmul_precision
def pairwise_pallas(x, y, metric: str = "l2") -> torch.Tensor:
    """Distance matrix between rows of x [m, k] and y [n, k] under a
    fused epilogue metric: ``'l2'`` (squared), ``'cosine'`` (1 - cos)
    or ``'inner'`` (negative inner product). CUDA kernel:
    ``csrc/pairwise_tile.cu``."""
    if metric not in _METRIC_CODE:
        raise ValueError(f"unknown metric {metric!r}")
    x, y = _pair(x, y)
    tier = current_mode()
    return _pairwise_tile(tier, metric, _side(x, tier), _side(y, tier),
                          x.shape[0], y.shape[0], x.shape[1])


def pairwise_l2_pallas(x, y, sqrt: bool = False) -> torch.Tensor:
    """Squared (or rooted) L2 distance matrix, clamped at >= 0. CUDA
    kernel: ``csrc/pairwise_tile.cu``."""
    out = torch.clamp_min(pairwise_pallas(x, y, "l2"), 0.0)
    return torch.sqrt(out) if sqrt else out


@with_matmul_precision
def fused_argmin_pallas(x, y, metric: str = "l2"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(min_dist [m] f32, argmin [m] int32)`` of each row of x against
    the rows of y under a fused metric, never materialising the m x n
    matrix. Ties go to the smaller index and a NaN distance is minimal.
    CUDA kernel: ``csrc/fused_argmin.cu``."""
    if metric not in _METRIC_CODE:
        raise ValueError(f"unknown metric {metric!r}")
    x, y = _pair(x, y)
    tier = current_mode()
    return _fused_argmin(tier, metric, _side(x, tier), _side(y, tier),
                         x.shape[0], y.shape[0], x.shape[1])


def fused_l2_argmin_pallas(x, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(min_dist² clamped at >= 0, argmin)`` under squared L2. CUDA
    kernel: ``csrc/fused_argmin.cu``."""
    val, idx = fused_argmin_pallas(x, y, "l2")
    return torch.clamp_min(val, 0.0), idx


@with_matmul_precision
def lloyd_prepare(x, n_clusters: int):
    """Hoist the loop-invariant X work of the tier-'high' Lloyd pass
    (X's bf16 halves and row norms) out of the iteration loop.

    Returns ``(ops, meta)``: ``ops = (xh, xl, xn)`` for
    :func:`fused_lloyd_prepared`, ``meta = {"m": rows}`` its keyword
    arguments; or ``(None, None)`` when the tier is not ``'high'`` (the
    caller then uses :func:`fused_lloyd_pallas`). On the card the halves
    are already in the wgmma layout (depth and row stride padded with
    zero columns to a multiple of 8), so no iteration re-pads them.
    Results of the prepared pass are bitwise those of
    :func:`fused_lloyd_pallas`: same kernel, same operand bytes."""
    x = _as_f32(x)
    if x.dim() != 2 or n_clusters < 1:
        raise ValueError("expected x [m, k] and n_clusters >= 1")
    if current_mode() != "high":
        return None, None
    xh, xl, xn = _split_side(x)
    m, k = x.shape
    if x.device.type == "cuda":
        side = _wgmma_side(Side(xh, xl, xn), "high", m, k,
                           cdiv(k, WGMMA_DEPTH) * WGMMA_DEPTH)
        xh, xl = side.v0, side.v1
    return (xh, xl, xn), {"m": int(m)}


@with_matmul_precision
def fused_lloyd_prepared(ops, y, *, m: int):
    """Per-iteration half of the prepared Lloyd pass: split the centroids
    and run the fused Lloyd kernel against the hoisted X operands.

    ``ops`` may also be the reference package's operands (padded to its
    tile grid, carried over by ``raft_tpu_torch.interop``): only rows
    ``< m`` are read, and of the columns past ``y.shape[1]`` only zeros
    (both packages pad with zeros), as the wgmma route's depth padding.
    Same return contract as :func:`fused_lloyd_pallas`. CUDA kernel:
    ``csrc/fused_lloyd.cu``."""
    xh, xl, xn = ops
    y = _as_f32(y)
    n, k = y.shape
    xs = Side(xh, xl, xn.reshape(-1))
    return _fused_lloyd("high", xs, _side(y, "high"), m, n, k,
                        x_zero_tail=True)


@with_matmul_precision
def fused_lloyd_pallas(x, y) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """One Lloyd iteration's data pass in one kernel.

    Returns ``(sums [n, k] f32, counts [n] f32, min_dist² [m] f32
    clamped at >= 0, labels [m] int32)``; the caller divides sums by
    counts. Sums are accumulated in a fixed order, so the result is
    bitwise the same from run to run. CUDA kernel:
    ``csrc/fused_lloyd.cu``."""
    x, y = _pair(x, y)
    tier = current_mode()
    return _fused_lloyd(tier, _side(x, tier), _side(y, tier),
                        x.shape[0], y.shape[0], x.shape[1])


# ---------------------------------------------------------------------------
# unexpanded metrics (no GEMM form): csrc/unexpanded_tile.cu
# ---------------------------------------------------------------------------

UNEXPANDED_METRICS = ("l1", "linf", "canberra", "lp", "hamming", "l2un")
_UNEXPANDED_CODE = {m: i for i, m in enumerate(UNEXPANDED_METRICS)}
_UNEXPANDED_DTYPE = {torch.float32: 0, torch.float64: 1}


def _unexpanded_term(metric: str, a, b, p: float):
    """One depth's term f(a, b) of the metric, broadcast over a [m, 1]
    and b [1, n]."""
    if metric in ("l1", "linf"):
        return (a - b).abs()
    if metric == "l2un":
        d = a - b
        return d * d
    if metric == "canberra":
        den = a.abs() + b.abs()
        pos = den > 0
        return torch.where(pos, (a - b).abs() / torch.where(pos, den, 1.0),
                           0.0)
    if metric == "lp":
        return (a - b).abs() ** p
    return (a != b).to(a.dtype)                  # hamming


def unexpanded_ref(x, y, metric: str, p: float = 2.0) -> torch.Tensor:
    """Plain version of the unexpanded tile, and the reference's oracle:
    raw reductions (the caller applies lp's ``^(1/p)``, hamming's ``/k``
    and l2un's sqrt), in f64 where an operand is f64, else f32.

    Each output sums its terms one depth at a time, in order, as the
    kernel does, so the two agree bit for bit but for lp's pow; linf's
    max propagates NaN; canberra gives 0 where ``|a| + |b| > 0`` fails
    (0/0, or a NaN denominator); hamming counts ``a != b`` (NaN != NaN
    counts 1). Memory: a few [m, n] tensors, never [m, n, k]."""
    if metric not in UNEXPANDED_METRICS:
        raise ValueError(f"metric must be one of {UNEXPANDED_METRICS}")
    x, y = _unexpanded_pair(x, y)
    acc = torch.zeros((x.shape[0], y.shape[0]), dtype=x.dtype,
                      device=x.device)
    for c in range(x.shape[1]):
        v = _unexpanded_term(metric, x[:, c:c + 1], y[None, :, c], p)
        acc = torch.maximum(acc, v) if metric == "linf" else acc + v
    return acc


def _unexpanded_pair(x, y):
    """x [m, k] and y [n, k] in the working type: f64 where either is
    f64, else f32 (bf16 is cast exactly, as the TPU kernel casts)."""
    x, y = as_tensor(x), as_tensor(y)
    dt = (torch.float64 if torch.float64 in (x.dtype, y.dtype)
          else torch.float32)
    x, y = x.to(dt), y.to(dt)
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"expected x [m, k] and y [n, k], got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if min(x.shape[0], y.shape[0], x.shape[1]) < 1:
        raise ValueError("empty operand")
    if x.device != y.device:
        raise ValueError(f"operands on different devices: {x.device}, "
                         f"{y.device}")
    return x, y


def _unexpanded_tile(metric: str, p: float, x: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """[m, n] raw reduction of x [m, k] against y [n, k] (both f32 or
    both f64, unit column stride): csrc/unexpanded_tile.cu on CUDA, the
    plain version on the CPU."""
    if x.device.type == "cpu":
        return unexpanded_ref(x, y, metric, p)
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"unsupported devices {x.device}, {y.device}")
    if x.dtype not in _UNEXPANDED_DTYPE or y.dtype != x.dtype:
        raise TypeError(f"x and y must both be f32 or both f64, got "
                        f"{x.dtype} and {y.dtype}")
    if x.stride(1) != 1 or y.stride(1) != 1:
        raise ValueError("x and y need unit column stride")
    m, k = x.shape
    n = y.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    p_bits = struct.unpack("<q", struct.pack("<d", float(p)))[0]
    kernels.launch("unexpanded_tile", x.device, _UNEXPANDED_DTYPE[x.dtype],
                   _UNEXPANDED_CODE[metric], p_bits, x.data_ptr(),
                   x.stride(0), y.data_ptr(), y.stride(0), out.data_ptr(), m,
                   n, k)
    return out


def pairwise_unexpanded_pallas(x, y, metric: str, p: float = 2.0,
                               tm: int = 128, tn: int = 256,
                               kc: int = 32) -> torch.Tensor:
    """Unexpanded pairwise metric matrix (``metric`` in
    :data:`UNEXPANDED_METRICS`): raw reductions only, the caller applies
    the metric's scalar epilogue (lp's ``^(1/p)``, hamming's ``/k``,
    l2un's sqrt). bf16 and other floats are computed in f32, f64 in f64
    (the reference's kernel takes f64 as f32; its jnp path keeps f64).

    ``tm``, ``tn`` and ``kc`` are the reference's TPU tile knobs: they are
    validated and choose nothing, since the kernel's tile (64 x 128 in
    f32, 64 x 64 in f64) masks ragged edges and needs no padding. CUDA
    kernel: ``csrc/unexpanded_tile.cu``."""
    if metric not in UNEXPANDED_METRICS:
        raise ValueError(f"metric must be one of {UNEXPANDED_METRICS}")
    for name, v in (("tm", tm), ("tn", tn), ("kc", kc)):
        if int(v) < 1:
            raise ValueError(f"{name} must be >= 1, got {v}")
    x, y = _unexpanded_pair(x, y)
    return _unexpanded_tile(metric, p, x.contiguous(), y.contiguous())
