"""Radix-rank select: exact batched top-k (counterpart of
``raft_tpu/matrix/radix_select.py``).

Two CUDA kernels over the int32 sortable keys of the values:

========================  =========================  ==================
stage                     CUDA kernel                plain version
========================  =========================  ==================
threshold (k-th key T,    csrc/radix_threshold.cu    _threshold_plain
tie quota n_tie)
emit (winner columns)     csrc/radix_emit.cu         _emit_plain
========================  =========================  ==================

The threshold narrows the k-th key digit by digit from the top, as the
reference's most-significant-digit passes do (11-bit digits here, in one
of two forms that :func:`_threshold_plan` picks from the shapes); the
emission writes every key below T, then the first ``n_tie`` keys equal
to T, each run in column order. The values are then gathered and stably
sorted by key (plain torch, as the reference does in XLA), so among
equal values the lower column comes first.

Key domain (:func:`_to_key`): floats map through the sign-magnitude
fold (IEEE total order: ``-NaN < -inf``, ``+NaN > +inf``); integers
widen; uint32 re-biases; select_max is ``~key``. Supported: f32, bf16,
f16, int8, int16, int32, uint8, uint16 and uint32 values, ``n_cols <=``
:data:`MAX_LEN`, ``k <=`` :data:`MAX_K`. Rows past :data:`CHUNK_LEN`
run the reference's exact two-level scheme.

The reference's TPU tile planning (``_emit_tiles``, ``_hist_tiles``, the
VMEM live-set models) has no counterpart: the CUDA kernels split long
rows across blocks (:func:`_threshold_plan`, :func:`_emit_plan`)
instead.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Tuple

import torch

from raft_tpu_torch import kernels
from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.matrix import _topk_order
from raft_tpu_torch.util.math import cdiv, round_up_to_multiple

_I32_MAX = 0x7FFFFFFF
_I32_MIN = -0x80000000

CHUNK_LEN = 1 << 20
MAX_LEN = 1 << 24
MAX_K = 16384
MIN_COLS = 8192

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int8,
           torch.int16, torch.int32, torch.uint8, torch.uint16, torch.uint32)

# Blocks the CUDA kernels aim for: four per SM of a 132-SM H100. A row
# gets more than one block only when the rows alone give fewer; fixed by
# the shapes, never by the card.
TARGET_BLOCKS = 528


def supports(dtype: torch.dtype, n_cols: int, k: int) -> bool:
    """Whether the radix path handles this problem (callers fall back)."""
    ok = dtype in _DTYPES
    if n_cols > CHUNK_LEN:
        # two-level: the merge pool must itself be a supported problem
        n_chunks = cdiv(n_cols, CHUNK_LEN)
        if n_chunks * k > CHUNK_LEN:
            return False
    return ok and k <= n_cols and n_cols <= MAX_LEN and k <= MAX_K


def preferred(n_cols: int, k: int) -> bool:
    """The dispatch band where radix is expected to win, shared by
    select_k AUTO and the chunked kNN path. The bands were measured on a
    TPU v5e by the reference package and are kept unchanged, so that the
    port takes the reference's route on every shape; they are not
    measured on this card."""
    if n_cols > MAX_LEN:
        return False
    if n_cols >= (1 << 20):
        return 256 < k <= MAX_K
    return n_cols >= MIN_COLS and 16 < k <= MAX_K


def _to_key(values: torch.Tensor, select_min: bool) -> torch.Tensor:
    """Order-preserving map into int32 ("sortable key"): ascending key is
    ascending IEEE-total-order value."""
    v = values
    if v.is_floating_point():
        key = _topk_order.sortable_key(v)
    elif v.dtype == torch.uint32:
        # unsigned order -> signed order: subtract 2^31
        key = (v.to(torch.int64) + _I32_MIN).to(torch.int32)
    else:
        key = v.to(torch.int32)
    return key if select_min else ~key


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _threshold_plain(keys: torch.Tensor, k: int):
    """Per row: the k-th smallest key T and the tie quota
    ``n_tie = k - #(keys < T)``, both int32 [rows]."""
    t = torch.sort(keys, dim=1).values[:, k - 1]
    below = (keys < t[:, None]).sum(1)
    return t.to(torch.int32), (k - below).to(torch.int32)


def _emit_plain(keys: torch.Tensor, t: torch.Tensor, ntie: torch.Tensor,
                k: int) -> torch.Tensor:
    """Winner columns int32 [rows, k]: the keys below T in column order,
    then the first ``n_tie`` keys equal to T in column order."""
    strict = keys < t[:, None]
    tie = keys == t[:, None]
    tie_rank = torch.cumsum(tie.to(torch.int32), dim=1) - 1
    member_tie = tie & (tie_rank < ntie[:, None])
    cls = torch.where(strict, 0, torch.where(member_tie, 1, 2))
    order = torch.sort(cls.to(torch.int32), dim=1, stable=True).indices
    return order[:, :k].to(torch.int32)


# ---------------------------------------------------------------------------
# kernel wrappers: CPU tensors take the plain version, CUDA tensors the
# kernel
# ---------------------------------------------------------------------------


# csrc/radix_threshold.cu's layout, which its constants kBins,
# kStreamPasses, kScratchWords and kRowCand (kRowFixedBytes) state again:
# 2,048-bin histograms (11-bit digits), the streaming form's three passes,
# and the row-resident form's shared memory (histogram, 64 words of
# scratch, a 2,048-key candidate buffer, then the row, up to 3 keys of
# misalignment, in 16-byte groups) against the block's opt-in limit
THRESHOLD_BINS = 2048
THRESHOLD_PASSES = 3
ROW_FIXED_BYTES = 4 * (THRESHOLD_BINS + 64 + 2048)
MIN_CANDIDATES = 4096

ThresholdPlan = namedtuple("ThresholdPlan", "form splits span cand_cap "
                           "scratch_bytes smem_bytes")


def _smem_optin(dev: torch.device) -> int:
    """The shared memory a block of ``dev`` may opt in to, bytes."""
    return torch.cuda.get_device_properties(dev).shared_memory_per_block_optin


def _row_keys_max(smem_optin: int) -> int:
    """The longest row the row-resident form holds in ``smem_optin``
    bytes of shared memory."""
    return (smem_optin - ROW_FIXED_BYTES) // 4 - 3


def _threshold_plan(rows: int, n_cols: int,
                    smem_optin: int) -> ThresholdPlan:
    """How csrc/radix_threshold.cu runs on ``rows`` rows of ``n_cols``
    keys, from the shapes and a block's opt-in shared memory
    (:func:`_smem_optin`):

    - ``form`` ``"row"`` where a row fits in a block's shared memory
      (``n_cols <=`` :func:`_row_keys_max`): a block a row reads it once
      and runs every pass there; ``splits`` 1, no global scratch,
      ``smem_bytes`` its shared memory;
    - else ``"stream"``: ``splits`` blocks a row (enough for the card when
      the rows are few, at least 4,096 keys each) over spans of ``span``
      keys; a candidate buffer of ``cand_cap`` keys a row (a 16th of the
      row, at least :data:`MIN_CANDIDATES`, a multiple of 4) that the
      second pass fills where the first pass's bin fits, so the third
      reads only it; ``scratch_bytes`` the histograms, counters and
      buffers the wrapper allocates."""
    if rows < 1 or n_cols < 1:
        raise ValueError(f"bad threshold plan arguments rows={rows} "
                         f"n_cols={n_cols}")
    if n_cols <= _row_keys_max(smem_optin):
        smem = ROW_FIXED_BYTES + 4 * round_up_to_multiple(n_cols + 3, 4)
        return ThresholdPlan("row", 1, n_cols, 0, 0, smem)
    splits = max(1, min(cdiv(TARGET_BLOCKS, rows), cdiv(n_cols, 4096),
                        65535))
    span = round_up_to_multiple(cdiv(n_cols, splits), 1024)
    cap = round_up_to_multiple(min(n_cols, max(MIN_CANDIDATES,
                                               n_cols // 16)), 4)
    scratch = 4 * (THRESHOLD_PASSES * rows * THRESHOLD_BINS + rows
                   + rows * cap)
    return ThresholdPlan("stream", cdiv(n_cols, span), span, cap, scratch, 0)


# csrc/radix_emit.cu's chunk, which its kEmitChunk states again: 256
# threads, 8 16-byte groups a thread
EMIT_CHUNK = 8192

EmitPlan = namedtuple("EmitPlan", "form splits span scratch_bytes")


def _emit_plan(rows: int, n_cols: int) -> EmitPlan:
    """How csrc/radix_emit.cu runs on ``rows`` rows of ``n_cols`` keys:

    - ``form`` ``"walk"`` where the rows alone fill the card (at least
      :data:`TARGET_BLOCKS`, as at the kNN chunks) or a row is one chunk
      of :data:`EMIT_CHUNK` keys: a block a row walks it once with running
      ranks; ``splits`` 1, no scratch;
    - else ``"lookback"``: ``splits`` blocks a row, each one chunk
      (``span`` :data:`EMIT_CHUNK` keys) held in registers between its
      count and its emission, ranked by a chained scan with decoupled
      look-back; ``scratch_bytes`` a 64-bit look-back word a block and a
      32-bit ticket a row, which the kernel zeroes."""
    if rows < 1 or n_cols < 1:
        raise ValueError(f"bad emit plan arguments rows={rows} "
                         f"n_cols={n_cols}")
    if rows >= TARGET_BLOCKS or n_cols <= EMIT_CHUNK:
        return EmitPlan("walk", 1, n_cols, 0)
    splits = cdiv(n_cols, EMIT_CHUNK)
    return EmitPlan("lookback", splits, EMIT_CHUNK,
                    8 * rows * splits + 4 * rows)


def _check_keys(keys: torch.Tensor, k: int):
    if (keys.dtype != torch.int32 or keys.dim() != 2
            or keys.stride(1) != 1):
        raise ValueError("keys must be 2-D int32 with unit column stride")
    rows, n = keys.shape
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= {n}, got {k}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")
    return rows, n


def _radix_threshold(keys: torch.Tensor, k: int):
    """``(T, n_tie)`` int32 [rows]: csrc/radix_threshold.cu on CUDA."""
    rows, n = _check_keys(keys, k)
    if keys.device.type == "cpu":
        return _threshold_plain(keys, k)
    dev = keys.device
    plan = _threshold_plan(rows, n, _smem_optin(dev))
    t = torch.empty((rows,), dtype=torch.int32, device=dev)
    ntie = torch.empty((rows,), dtype=torch.int32, device=dev)
    hist = cand = None
    if plan.form == "stream":
        hist = torch.empty((THRESHOLD_PASSES * rows * THRESHOLD_BINS
                            + rows,), dtype=torch.int32, device=dev)
        cand = torch.empty((rows, plan.cand_cap), dtype=torch.int32,
                           device=dev)
    kernels.launch("radix_threshold", dev, keys.data_ptr(), keys.stride(0),
                   rows, n, k, int(plan.form == "row"), plan.span,
                   None if hist is None else hist.data_ptr(),
                   None if cand is None else cand.data_ptr(), plan.cand_cap,
                   t.data_ptr(), ntie.data_ptr())
    return t, ntie


def _radix_emit(keys: torch.Tensor, t: torch.Tensor, ntie: torch.Tensor,
                k: int) -> torch.Tensor:
    """Winner columns int32 [rows, k]: csrc/radix_emit.cu on CUDA."""
    rows, n = _check_keys(keys, k)
    if keys.device.type == "cpu":
        return _emit_plain(keys, t, ntie, k)
    dev = keys.device
    for a in (t, ntie):
        if (a.dtype != torch.int32 or a.shape != (rows,)
                or not a.is_contiguous() or a.device != dev):
            raise ValueError("t and ntie must be contiguous int32 [rows] on "
                             "the keys' device")
    plan = _emit_plan(rows, n)
    scratch = (torch.empty((plan.scratch_bytes,), dtype=torch.uint8,
                           device=dev) if plan.scratch_bytes else None)
    out = torch.empty((rows, k), dtype=torch.int32, device=dev)
    kernels.launch("radix_emit", dev, keys.data_ptr(), keys.stride(0), rows,
                   n, k, t.data_ptr(), ntie.data_ptr(), plan.splits,
                   None if scratch is None else scratch.data_ptr(),
                   out.data_ptr())
    return out


def _radix_ranks(keys: torch.Tensor, k: int) -> torch.Tensor:
    """keys (R, L) int32 -> winner column indices (R, k) int32: strict-
    below first, then the in-order threshold ties."""
    t, ntie = _radix_threshold(keys, k)
    return _radix_emit(keys, t, ntie, k)


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------


def radix_select_k(values, k: int, select_min: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact batched top-k (smallest if select_min) of values (R, L).

    Returns ``(vals (R, k), idx (R, k) int64)`` sorted best-first; ties
    resolve to the lowest column indices. Callers check :func:`supports`
    first. A non-tensor input goes to ``cuda:0``. CUDA kernels:
    ``csrc/radix_threshold.cu``, ``csrc/radix_emit.cu``."""
    values = as_tensor(values)
    n_rows, n_cols = values.shape
    if not supports(values.dtype, n_cols, k):
        raise ValueError(
            f"radix_select_k: unsupported problem (dtype={values.dtype}, "
            f"n_cols={n_cols}, k={k}); check supports()")
    keys = _to_key(values, select_min).contiguous()

    if n_cols > CHUNK_LEN:
        # two-level exact select (the reference's scheme): per-chunk exact
        # top-k, then one exact merge select over the chunk-major C*k pool;
        # equal keys keep ascending column order through both levels
        n_chunks = cdiv(n_cols, CHUNK_LEN)
        lc = round_up_to_multiple(cdiv(n_cols, n_chunks), 1024)
        pad = n_chunks * lc - n_cols
        kc = torch.nn.functional.pad(keys, (0, pad), value=_I32_MAX
                                     ).reshape(n_rows * n_chunks, lc)
        idx_c = _radix_ranks(kc, k).to(torch.int64)
        pool_k = torch.gather(kc, 1, idx_c).reshape(n_rows, n_chunks * k)
        vc = torch.nn.functional.pad(values, (0, pad)).reshape(
            n_rows * n_chunks, lc)
        pool_v = _topk_order.gather(vc, idx_c).reshape(n_rows,
                                                       n_chunks * k)
        base = (torch.arange(n_chunks, device=values.device) * lc)[None, :,
                                                                   None]
        pool_i = (idx_c.reshape(n_rows, n_chunks, k) + base
                  ).reshape(n_rows, n_chunks * k)
        idx_m = _radix_ranks(pool_k.contiguous(), k).to(torch.int64)
        idx = torch.gather(pool_i, 1, idx_m)
        out_k = torch.gather(pool_k, 1, idx_m)
        out_v = _topk_order.gather(pool_v, idx_m)
    else:
        idx = _radix_ranks(keys, k).to(torch.int64)
        out_v = _topk_order.gather(values, idx)
        out_k = torch.gather(keys, 1, idx)
    # best-first: a stable sort by key keeps the emission's column order
    # among equal values
    order = torch.sort(out_k, dim=1, stable=True).indices
    return (_topk_order.gather(out_v, order), torch.gather(idx, 1, order))
