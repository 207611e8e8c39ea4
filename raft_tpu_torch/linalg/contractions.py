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
============================  ==========================  ================

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
plain version, which computes the same function with the same tie, NaN
and padding rules. There is no fallback from the kernel to the plain
version.

Operands follow the precision tier in effect (``util/precision.py``):
at ``'high'`` each f32 side is split once into bf16 hi/lo halves plus
f32 squared row norms (:func:`_split_side`, plain torch outside the
kernel, as in the reference package); at ``'default'`` and ``'highest'``
the kernel reads f32 rows and the norms are computed the same way.
Inputs of any float dtype are taken as f32.

The TPU tile knobs of the reference functions (``tm``, ``tn``,
``packed``, ``counts_mxu``) have no counterpart: the CUDA kernels use
fixed 128 x 128 tiles whose shared memory (34 KB at ``'high'``) is far
inside Hopper's 227 KB a block, and need no padding (they mask ragged
edges), so the reference's VMEM planner and its fallback path are gone.
What is left to plan is the persistent grid of the Lloyd pass
(:func:`_lloyd_blocks`).
"""

from __future__ import annotations

from collections import namedtuple
from typing import Optional, Tuple

import torch

from raft_tpu_torch import kernels
from raft_tpu_torch.matrix.epilogue import assign_onehot, iota_argmin
from raft_tpu_torch.util.math import cdiv
from raft_tpu_torch.util.precision import current_mode, with_matmul_precision

_TIER_CODE = {"default": 0, "high": 1, "highest": 2}
_METRIC_CODE = {"l2": 0, "cosine": 1, "inner": 2}
_COSINE_EPS = 1e-30

# Row tile of the kernels (csrc/common.cuh BM).
TILE_M = 128

# Persistent grid of the Lloyd pass: two blocks per SM of a 132-SM H100,
# fixed by the shapes and never by the card, so the order of the sums (and
# with it every bit of the result) is the same on any card. Each block
# owns a partial [n, k] sum (two at tier 'high'); the scratch is capped.
LLOYD_BLOCKS = 264
LLOYD_SCRATCH_BYTES = 1 << 30

# One side of a contraction in the tier's operand format: v0 (f32 rows,
# or the bf16 hi halves at 'high'), v1 (the bf16 lo halves, else None),
# norms (f32 squared row norms, 1-D).
Side = namedtuple("Side", "v0 v1 norms")


# ---------------------------------------------------------------------------
# operand preparation (plain torch, outside the kernels)
# ---------------------------------------------------------------------------


def _as_f32(a) -> torch.Tensor:
    a = torch.as_tensor(a)
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


def _pairwise_tile(tier: str, metric: str, xs: Side, ys: Side,
                   m: int, n: int, k: int) -> torch.Tensor:
    """Distance matrix [m, n]: csrc/pairwise_tile.cu on CUDA."""
    if _on_cpu(xs, ys):
        return _pairwise_plain(tier, metric, xs, ys, m, n, k)
    _check_side(xs, tier, m, k, "x")
    _check_side(ys, tier, n, k, "y")
    dev = xs.v0.device
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    kernels.launch("pairwise_tile", dev, _TIER_CODE[tier],
                   _METRIC_CODE[metric], *_operand_args(xs, ys),
                   out.data_ptr(), m, n, k)
    return out


def _fused_argmin(tier: str, metric: str, xs: Side, ys: Side,
                  m: int, n: int, k: int):
    """Per-row (min, first-min argmin): csrc/fused_argmin.cu on CUDA."""
    if _on_cpu(xs, ys):
        return _argmin_plain(tier, metric, xs, ys, m, n, k)
    _check_side(xs, tier, m, k, "x")
    _check_side(ys, tier, n, k, "y")
    dev = xs.v0.device
    val = torch.empty((m,), dtype=torch.float32, device=dev)
    idx = torch.empty((m,), dtype=torch.int32, device=dev)
    kernels.launch("fused_argmin", dev, _TIER_CODE[tier],
                   _METRIC_CODE[metric], *_operand_args(xs, ys),
                   val.data_ptr(), idx.data_ptr(), m, n, k)
    return val, idx


def _lloyd_blocks(m: int, n: int, k: int, tier: str) -> int:
    """Persistent blocks of the Lloyd pass: :data:`LLOYD_BLOCKS`, fewer
    when there are fewer row tiles, or when the partial sums would
    exceed :data:`LLOYD_SCRATCH_BYTES`."""
    halves = 2 if tier == "high" else 1
    per_block = 4 * n * (k * halves + 1)
    return max(1, min(LLOYD_BLOCKS, cdiv(m, TILE_M),
                      LLOYD_SCRATCH_BYTES // per_block))


def _fused_lloyd(tier: str, xs: Side, ys: Side, m: int, n: int, k: int,
                 blocks: Optional[int] = None):
    """(sums, counts, clamped min dist², labels): csrc/fused_lloyd.cu on
    CUDA, on ``blocks`` persistent blocks (default :func:`_lloyd_blocks`;
    a test passes fewer to put many row tiles on each block)."""
    if _on_cpu(xs, ys):
        return _lloyd_plain(tier, xs, ys, m, n, k)
    _check_side(xs, tier, m, k, "x")
    _check_side(ys, tier, n, k, "y")
    dev = xs.v0.device
    if blocks is None:
        blocks = _lloyd_blocks(m, n, k, tier)
    elif blocks < 1:
        raise ValueError(f"blocks must be >= 1, got {blocks}")
    f32 = dict(dtype=torch.float32, device=dev)
    sums = torch.empty((n, k), **f32)
    counts = torch.empty((n,), **f32)
    val = torch.empty((m,), **f32)
    idx = torch.empty((m,), dtype=torch.int32, device=dev)
    part0 = torch.empty((blocks, n, k), **f32)
    part1 = torch.empty((blocks, n, k), **f32) if tier == "high" else None
    part_cnt = torch.empty((blocks, n), dtype=torch.int32, device=dev)
    kernels.launch("fused_lloyd", dev, _TIER_CODE[tier],
                   *_operand_args(xs, ys), sums.data_ptr(),
                   counts.data_ptr(), val.data_ptr(), idx.data_ptr(),
                   part0.data_ptr(), _ptr(part1), part_cnt.data_ptr(),
                   blocks, m, n, k)
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
    caller then uses :func:`fused_lloyd_pallas`). Results of the prepared
    pass are bitwise those of :func:`fused_lloyd_pallas`: same kernel,
    same operand bytes."""
    x = _as_f32(x)
    if x.dim() != 2 or n_clusters < 1:
        raise ValueError("expected x [m, k] and n_clusters >= 1")
    if current_mode() != "high":
        return None, None
    return _split_side(x), {"m": int(x.shape[0])}


@with_matmul_precision
def fused_lloyd_prepared(ops, y, *, m: int):
    """Per-iteration half of the prepared Lloyd pass: split the centroids
    and run the fused Lloyd kernel against the hoisted X operands.

    ``ops`` may also be the reference package's operands (padded to its
    tile grid, carried over by ``raft_tpu_torch.interop``): only rows
    ``< m`` and the first ``y.shape[1]`` columns are read. Same return
    contract as :func:`fused_lloyd_pallas`. CUDA kernel:
    ``csrc/fused_lloyd.cu``."""
    xh, xl, xn = ops
    y = _as_f32(y)
    n, k = y.shape
    xs = Side(xh, xl, xn.reshape(-1))
    return _fused_lloyd("high", xs, _side(y, "high"), m, n, k)


@with_matmul_precision
def fused_lloyd_pallas(x, y) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """One Lloyd iteration's data pass in one kernel.

    Returns ``(sums [n, k] f32, counts [n] f32, min_dist² [m] f32
    clamped at >= 0, labels [m] int32)``; the caller divides sums by
    counts. X is read once; sums are accumulated in a fixed order, so the
    result is bitwise the same from run to run. CUDA kernel:
    ``csrc/fused_lloyd.cu``."""
    x, y = _pair(x, y)
    tier = current_mode()
    return _fused_lloyd(tier, _side(x, tier), _side(y, tier),
                        x.shape[0], y.shape[0], x.shape[1])
