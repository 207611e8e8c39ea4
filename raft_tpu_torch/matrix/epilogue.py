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

The insertion drain (``insert_drain`` in the reference) is inlined by
two kernels, ``csrc/fused_topk.cu`` and ``csrc/topk_insert.cu``, through
``csrc/topk_common.cuh``; :func:`insert_drain_plain` is its contract in
PyTorch. The reference's MXU counting helpers (``onehot_pair``,
``onehot_histogram``, ``slot_onehot``) have no counterpart here: on
Hopper the radix kernels count with shared-memory integer atomics
(``csrc/radix_threshold.cu``, ``csrc/radix_emit.cu``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.matrix import _topk_order, radix_select
from raft_tpu_torch.util.math import round_up_to_multiple

_INT32_MAX = torch.iinfo(torch.int32).max

LANES = 128
MAX_K = 2 * LANES   # sorted-best width of the insertion drain (k <= 256;
                    # larger k takes the radix path)
# Default drain-strip width of the reference's drain; here only validated
# (resolve_tn_sw), the CUDA kernels have no strips.
DRAIN_SW = 256


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


def row_min_arg(pool: torch.Tensor, col: torch.Tensor):
    """Per-row ``(min, first-min argmin)`` of a ``(tm, tn)`` pool whose
    column indices the caller holds, keepdims ``(tm, 1)``. Nothing in the
    port calls it; it is kept for parity with the reference's public
    names."""
    pm = torch.amin(pool, dim=1, keepdim=True)
    sentinel = torch.full((), _INT32_MAX, dtype=col.dtype, device=col.device)
    pidx = torch.amin(torch.where(pool == pm, col, sentinel), dim=1,
                      keepdim=True)
    return pm, pidx


# ---------------------------------------------------------------------------
# bound-gated insertion drain
# ---------------------------------------------------------------------------


def resolve_tn_sw(tn: int, sw: Optional[int], n: int):
    """The reference's tile-width clamp and strip-width contract: lane-
    align ``tn``, clamp it to the data width, validate ``sw`` against the
    requested ``tn`` (an ``sw`` that never divided it raises
    ``ValueError``). Returns ``(tn, sw)``. The CUDA kernels take neither
    knob; callers validate them here so that they fail where the
    reference fails."""
    tn_req = max(128, tn - tn % 128)
    tn = min(tn_req, round_up_to_multiple(n, 128))
    if sw is None:
        sw = DRAIN_SW if tn_req % DRAIN_SW == 0 else 0
    if sw and (sw < 0 or sw % 128 or tn_req % sw):
        raise ValueError(f"sw must be a positive lane-aligned divisor "
                         f"of tn={tn_req}")
    if sw and tn % sw:
        sw = 0
    return tn, sw


def best_width(k: int) -> int:
    """Lane-aligned width of the reference's sorted-best buffer (128 for
    k <= 128, 256 for k <= 256). The CUDA kernels keep exactly k slots;
    this is kept for parity with the reference's public names."""
    return LANES * ((k + LANES - 1) // LANES)


def insert_drain_plain(dist: torch.Tensor, k: int):
    """The insertion drain's contract over a materialised ``(m, n)``
    block: per row the k smallest ``(value, column)`` pairs in f32, values
    compared as IEEE floats (``-0.0 == +0.0``, the smaller column first),
    NaN and +inf never entering, empty slots ``(+inf, 0)``. Returns
    ``(vals f32 [m, k], idx int32 [m, k])``. The plain version of
    ``csrc/fused_topk.cu`` and ``csrc/topk_insert.cu``."""
    d = dist.to(torch.float32)
    inf = torch.full((), float("inf"), device=d.device)
    d = torch.where(torch.isnan(d), inf, d)
    if d.shape[1] < k:                  # fewer columns than slots: empty
        d = torch.nn.functional.pad(d, (0, k - d.shape[1]),
                                    value=float("inf"))
    # sort a copy with -0.0 folded onto +0.0; gather the values themselves
    order = torch.sort(torch.where(d == 0, torch.zeros_like(d), d), dim=1,
                       stable=True).indices[:, :k]
    vals = torch.gather(d, 1, order)
    idx = torch.where(vals == inf, torch.zeros_like(order), order)
    return vals, idx.to(torch.int32)


def insert_drain_ref(values, k: int):
    """The reference's twin of the drain: ascending top-k by value with
    first-index ties (``lax.top_k`` of the negation) and NaN mapped to
    +inf. Returns ``(vals f32, idx int64)``. Nothing in the port calls
    it; it is kept for parity with the reference's public names. A
    non-tensor input goes to ``cuda:0``."""
    v = as_tensor(values).to(torch.float32)
    v = torch.where(torch.isnan(v), torch.full_like(v, float("inf")), v)
    return _topk_order.topk(v, k, largest=False)


# ---------------------------------------------------------------------------
# masked scoring epilogue
# ---------------------------------------------------------------------------


def masked_topk(dist: torch.Tensor, valid: Optional[torch.Tensor], k: int,
                use_radix: bool):
    """Validity-masked ascending top-k of a materialised ``(m, n)`` score
    block: invalid slots become +inf. ``use_radix`` takes the radix
    select (two CUDA kernels), else the stable key sort of
    ``lax.top_k``'s order. Returns ``(vals, positions)``."""
    if valid is not None:
        dist = torch.where(valid, dist,
                           torch.full((), float("inf"), dtype=dist.dtype,
                                      device=dist.device))
    if use_radix:
        return radix_select.radix_select_k(dist, k)
    return _topk_order.topk(dist, k, largest=False)


# ---------------------------------------------------------------------------
# per-row argmin/argmax API
# ---------------------------------------------------------------------------


def argmin(res, matrix) -> torch.Tensor:
    """Index (int32) of the minimum of each row; the smallest index wins
    ties and a NaN is minimal, as ``jnp.argmin``. A non-tensor input goes
    to the handle's device."""
    m = as_tensor(matrix, res)
    if m.is_floating_point():
        return iota_argmin(m, m.shape[1])[2][:, 0]
    return torch.argmin(m, dim=1).to(torch.int32)


def argmax(res, matrix) -> torch.Tensor:
    """Index (int32) of the maximum of each row, as ``jnp.argmax``."""
    m = as_tensor(matrix, res)
    if m.is_floating_point():
        return iota_argmin(-m, m.shape[1])[2][:, 0]
    return torch.argmax(m, dim=1).to(torch.int32)
