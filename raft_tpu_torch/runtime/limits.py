"""Workload limits of the port: deadlines, work budgets with admission
control, circuit breakers and rate budgets (counterpart of
``raft_tpu/runtime/limits.py``; the budget's wiring into ``knn``,
``pairwise_distance`` and ``gemm`` is ROADMAP queue A item 13b).

``Deadline`` / :func:`deadline_scope`
    An absolute-time budget carried in a thread-local scope. Host-driver
    loops poll :func:`check_deadline` at their cancellation boundaries;
    the comms layer caps blocking-recv waits and retry backoff with it,
    so a deadline on one rank bounds the whole exchange instead of
    racing a fixed recv timeout.

``WorkBudget`` / :func:`budget_scope`
    A device-memory admission limit in bytes, seeded from an explicit
    count, ``torch.cuda.mem_get_info`` (:meth:`WorkBudget.from_device`)
    or ``RAFT_TPU_HBM_BUDGET`` (a malformed value raises at import). The
    IVF searches consult :func:`estimate_bytes` before launching: an
    over-budget launch degrades to row chunks with the same bits
    (:func:`record_degraded`) or raises :class:`RejectedError`
    (:func:`reject`).

``CircuitBreaker``
    N consecutive typed failures per op key -> fast-fail with cooldown,
    protecting callers from retry storms against an op that keeps
    missing its deadline or budget.

:func:`estimate_seconds` / :func:`check_chunk_budget`
    A per-step seconds model (``max(flops / peak, bytes / bandwidth)``
    from :mod:`raft_tpu_torch.core.hw`'s sustained figures) and the
    pre-launch admission of a compiled chunk against the deadline's
    remaining slack (:mod:`raft_tpu_torch.runtime.compiled_driver`).

``RateBudget``
    A sliding-window spend budget for secondary work (retries, hedges)
    that must never amplify an overload.

With no deadline or budget scope active (the default) every poll is one
thread-local read.
"""

from __future__ import annotations

import collections as _collections
import contextlib
import threading
import time
from typing import Dict, Optional

from raft_tpu_torch import obs
from raft_tpu_torch.core import env as _env_mod
from raft_tpu_torch.core import hw as _hw

__all__ = [
    "DeadlineExceededError", "RejectedError",
    "Deadline", "deadline_scope", "current_deadline", "remaining",
    "check_deadline", "sleep_within_deadline",
    "WorkBudget", "budget_scope", "active_budget", "set_default_budget",
    "parse_bytes", "estimate_bytes", "estimate_flops_bytes",
    "estimate_seconds", "check_chunk_budget", "admit", "reject", "record_degraded",
    "CircuitBreaker", "get_breaker", "reset_breakers",
    "RateBudget",
]

# breaker policy: consecutive typed failures before opening, and how
# long an open breaker fast-fails before allowing a half-open probe
BREAKER_THRESHOLD = 5
BREAKER_COOLDOWN_S = 30.0


# ---------------------------------------------------------------------------
# taxonomy
# ---------------------------------------------------------------------------

class DeadlineExceededError(RuntimeError):
    """The active :class:`Deadline` expired before the operation
    finished.

    Parameters
    ----------
    message : human-readable description (always names the operation).
    op : dotted name of the operation that observed the expiry.
    budget_s : the scope's original time budget in seconds.
    """

    def __init__(self, message: str, *, op: Optional[str] = None,
                 budget_s: Optional[float] = None):
        super().__init__(message)
        self.op = op
        self.budget_s = budget_s


class RejectedError(RuntimeError):
    """The operation was refused up front — admission control, not a
    mid-flight failure.

    ``reason`` is ``'over_budget'`` (the footprint estimate exceeds the
    active :class:`WorkBudget` even for the tiled path) or
    ``'breaker_open'`` (the op's circuit breaker is fast-failing).
    ``estimate`` / ``budget`` carry the byte counts when known, so the
    caller can shrink the request instead of blind-retrying."""

    def __init__(self, message: str, *, op: Optional[str] = None,
                 estimate: Optional[int] = None,
                 budget: Optional[int] = None,
                 reason: str = "over_budget"):
        super().__init__(message)
        self.op = op
        self.estimate = estimate
        self.budget = budget
        self.reason = reason


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

class Deadline:
    """An absolute-time budget on the monotonic clock.

    Created with a relative budget in seconds; queried as
    :meth:`remaining`. Instances are immutable facts about wall time —
    scoping and nesting live in :func:`deadline_scope`."""

    __slots__ = ("budget_s", "expires_at", "_ops")

    def __init__(self, seconds: float):
        seconds = float(seconds)
        if not seconds >= 0.0:
            raise ValueError(
                f"deadline budget must be >= 0 seconds, got {seconds!r}")
        self.budget_s = seconds
        self.expires_at = time.monotonic() + seconds
        # op keys that polled this deadline — a clean scope exit counts
        # as a breaker success for each of them
        self._ops: set = set()

    def remaining(self) -> float:
        """Seconds left (negative once expired)."""
        return self.expires_at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0.0


_tls = threading.local()


def _deadline_stack():
    if not hasattr(_tls, "deadlines"):
        _tls.deadlines = []
    return _tls.deadlines


def _budget_stack():
    if not hasattr(_tls, "budgets"):
        _tls.budgets = []
    return _tls.budgets


def current_deadline() -> Optional[Deadline]:
    """The binding deadline: of every scope on this thread's stack, the
    one that expires first (a nested scope can tighten the budget but
    never extend past an enclosing one). None when no scope is active —
    the caller's fast path."""
    st = _deadline_stack()
    if not st:
        return None
    return min(st, key=lambda d: d.expires_at)


def remaining(default: Optional[float] = None) -> Optional[float]:
    """Seconds left on the binding deadline, or ``default`` when no
    deadline scope is active. The comms layer uses this to cap recv
    timeouts and retry backoff."""
    d = current_deadline()
    return default if d is None else d.remaining()


@contextlib.contextmanager
def deadline_scope(seconds: float):
    """Thread-local deadline for a region.

    Everything under the scope — solver host loops, blocking recvs,
    retry backoff — observes the budget through
    :func:`check_deadline` / :func:`remaining`. On a clean exit the
    remaining slack is recorded in the ``deadline_slack_seconds``
    histogram and the breakers of every op polled under the scope see a
    success."""
    d = Deadline(seconds)
    _deadline_stack().append(d)
    try:
        yield d
    except BaseException:
        _deadline_stack().pop()
        raise
    else:
        _deadline_stack().pop()
        if obs.enabled():
            obs.observe("deadline_slack_seconds", max(d.remaining(), 0.0),
                        help="time left when a deadline scope exits "
                             "cleanly (seconds)")
        for op in d._ops:
            get_breaker(op).record_success()


def check_deadline(op: str) -> None:
    """The deadline poll: no-op (one thread-local read) when no scope is
    active; raises :class:`DeadlineExceededError` once the binding
    deadline expires, and :class:`RejectedError` (``breaker_open``) when
    ``op``'s breaker is fast-failing.

    Rides the same host-sync boundaries as ``CancelToken.check()`` —
    solvers call it where they already poll for cancellation,
    checkpoints, or peer health."""
    d = current_deadline()
    if d is None:
        return
    br = get_breaker(op)
    if not br.allow():
        obs.inc("limits_rejected_total", 1, reason="breaker_open", op=op)
        exc = RejectedError(
            f"{op}: circuit breaker open after "
            f"{br.threshold} consecutive typed failures "
            f"(cooldown {br.cooldown_s:g}s) — fast-failing instead of "
            "burning the deadline", op=op, reason="breaker_open")
        obs.record_failure(exc)
        raise exc
    d._ops.add(op)
    rem = d.remaining()
    if rem <= 0.0:
        br.record_failure()
        obs.inc("limits_deadline_exceeded_total", 1, op=op)
        exc = DeadlineExceededError(
            f"{op}: deadline exceeded ({d.budget_s:g}s budget, "
            f"{-rem:.3f}s over)", op=op, budget_s=d.budget_s)
        obs.record_failure(exc)
        raise exc


def sleep_within_deadline(seconds: float, *, op: str = "sleep") -> None:
    """``time.sleep`` that honors the active deadline scope.

    With no scope active it is exactly ``time.sleep(seconds)``. Under a
    scope it sleeps in short slices and raises
    :class:`DeadlineExceededError` the moment the deadline expires —
    so a fault-injected stall (or any long backoff) cannot hold a
    sender past its budget."""
    if current_deadline() is None:
        time.sleep(seconds)
        return
    end = time.monotonic() + float(seconds)
    while True:
        check_deadline(op)
        rem = end - time.monotonic()
        if rem <= 0.0:
            return
        time.sleep(min(rem, 0.05))


# ---------------------------------------------------------------------------
# work budgets (device-memory admission)
# ---------------------------------------------------------------------------

# the byte-count parser of core/env.py, under the name the reference
# package's limits module exports
parse_bytes = _env_mod.parse_bytes


class WorkBudget:
    """A device-memory admission limit: the largest transient working
    set an instrumented op may plan for, in bytes. Seed it explicitly,
    from the env (``RAFT_TPU_HBM_BUDGET``) or from the card's free memory
    (:meth:`from_device`)."""

    __slots__ = ("limit_bytes",)

    def __init__(self, limit_bytes: int):
        limit_bytes = int(limit_bytes)
        if limit_bytes <= 0:
            raise ValueError(
                f"budget must be a positive byte count, got {limit_bytes}")
        self.limit_bytes = limit_bytes

    @classmethod
    def from_device(cls, device=None, *,
                    fraction: float = 0.9) -> "WorkBudget":
        """``fraction`` of the card's free bytes
        (``torch.cuda.mem_get_info``). Raises ``RuntimeError`` on a device
        that reports no memory limit (the CPU, or no CUDA): pass an
        explicit byte count there instead."""
        import torch

        dev = torch.device("cuda", 0) if device is None \
            else torch.device(device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            raise RuntimeError(
                "device reports no memory limit; seed WorkBudget with an "
                "explicit byte count or RAFT_TPU_HBM_BUDGET")
        free, _ = torch.cuda.mem_get_info(dev)
        return cls(max(int(free * float(fraction)), 1))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"WorkBudget(limit_bytes={self.limit_bytes})"


# process-global default budget, seeded from the env at import; a
# malformed value raises here, never reads as "unlimited"
_env_budget = _env_mod.read("RAFT_TPU_HBM_BUDGET")
_default_budget: Optional[WorkBudget] = (
    WorkBudget(parse_bytes(_env_budget, name="RAFT_TPU_HBM_BUDGET"))
    if _env_budget is not None and _env_budget.strip() != "" else None)


def set_default_budget(budget) -> Optional[WorkBudget]:
    """Set (or clear, with None) the process-wide admission budget, the
    programmatic twin of ``RAFT_TPU_HBM_BUDGET``: a :class:`WorkBudget`
    or a byte count. Returns the previous value."""
    global _default_budget
    prev = _default_budget
    if budget is None or isinstance(budget, WorkBudget):
        _default_budget = budget
    else:
        _default_budget = WorkBudget(budget)
    return prev


def active_budget() -> Optional[WorkBudget]:
    """The binding budget: the smallest of this thread's scopes, else the
    process-wide default, else None (admission off: instrumented ops run
    their exact unbudgeted path)."""
    st = _budget_stack()
    if st:
        return min(st, key=lambda b: b.limit_bytes)
    return _default_budget


@contextlib.contextmanager
def budget_scope(budget):
    """Thread-local admission budget for a region: a :class:`WorkBudget`,
    a byte count, or None to seed from the card's free memory
    (:meth:`WorkBudget.from_device`)."""
    if budget is None:
        b = WorkBudget.from_device()
    elif isinstance(budget, WorkBudget):
        b = budget
    else:
        b = WorkBudget(budget)
    _budget_stack().append(b)
    try:
        yield b
    finally:
        _budget_stack().pop()


# ---------------------------------------------------------------------------
# footprint estimation + admission (the reference's byte counts, from
# static shapes only)
# ---------------------------------------------------------------------------

def _est_pairwise(*, m, n, k, itemsize):
    # both operands resident + the full m x n output block
    return (m * k + n * k + m * n) * itemsize


def _est_knn(*, n_queries, n_db, n_dims, k, itemsize, dist_itemsize=4):
    # operands + the monolithic q x n distance block + top-k outputs
    return ((n_queries * n_dims + n_db * n_dims) * itemsize
            + n_queries * n_db * dist_itemsize
            + n_queries * k * (dist_itemsize + 4))


def _est_ivf_search(*, n_queries, probe_rows, n_dims, k, itemsize,
                    packed_rows=0, dist_itemsize=4):
    # resident packed lists + queries + the gathered q x probe_rows
    # candidate tile (rows, fine distances, ids, valid mask) + top-k
    return ((packed_rows * n_dims + n_queries * n_dims) * itemsize
            + n_queries * probe_rows
            * (n_dims * itemsize + dist_itemsize + 4 + 1)
            + n_queries * k * (dist_itemsize + 4))


def _est_ivf_mnmg_search(*, n_queries, probe_rows, n_dims, k, n_ranks,
                         itemsize, packed_rows=0, dist_itemsize=4):
    # one rank's footprint: its shard (packed_rows = per-rank rows), the
    # single-rank probe scan, the all-gathered [q, n_ranks * k] pool and
    # the final top-k
    return ((packed_rows * n_dims + n_queries * n_dims) * itemsize
            + n_queries * probe_rows
            * (n_dims * itemsize + dist_itemsize + 4 + 1)
            + n_queries * n_ranks * k * (dist_itemsize + 4)
            + n_queries * k * (dist_itemsize + 4))


def _est_ivf_pq_search(*, n_queries, nprobe, probe_rows, n_dims, k, m,
                       n_codes, itemsize=4, refine=0, packed_rows=0,
                       dist_itemsize=4):
    # resident codes (m bytes a row) + ids + queries, the per-(query,
    # probed list) LUT block, the gathered code tile (codes, ADC scores,
    # ids, valid mask), the refine stage's raw candidate tile when armed,
    # and the top-k outputs
    rr = max(k, refine)
    est = (packed_rows * (m + 4) + n_queries * n_dims * itemsize
           + n_queries * nprobe * m * n_codes * dist_itemsize
           + n_queries * probe_rows * (m + dist_itemsize + 4 + 1)
           + n_queries * rr * (dist_itemsize + 4))
    if refine:
        est += n_queries * rr * (n_dims * itemsize + dist_itemsize)
    return est


def _est_streaming_compact(*, packed_rows, n_dims, itemsize,
                           id_itemsize=4):
    # the double-buffered repack: old and new packed arrays + the
    # relabel pass's row reads
    return (2 * packed_rows * (n_dims * itemsize + id_itemsize)
            + packed_rows * n_dims * itemsize)


def _est_gemm(*, m, n, k, itemsize, out_itemsize=None):
    out_itemsize = itemsize if out_itemsize is None else out_itemsize
    return (m * k + k * n) * itemsize + m * n * out_itemsize


def _est_spmv(*, n_rows, n_cols, nnz, itemsize, index_itemsize=4):
    return (nnz * (itemsize + index_itemsize)
            + (n_cols + n_rows) * itemsize)


_ESTIMATORS = {
    "distance.pairwise_distance": _est_pairwise,
    "neighbors.brute_force_knn": _est_knn,
    "neighbors.ivf_search": _est_ivf_search,
    "neighbors.ivf_mnmg_search": _est_ivf_mnmg_search,
    "neighbors.ivf_pq_search": _est_ivf_pq_search,
    "neighbors.streaming_compact": _est_streaming_compact,
    "linalg.gemm": _est_gemm,
    "sparse.spmv": _est_spmv,
}


def estimate_bytes(op: str, **dims) -> int:
    """Per-op device-memory estimate of the monolithic launch, from
    static shapes only (never touches the device). Known ops:
    ``distance.pairwise_distance(m, n, k, itemsize)``,
    ``neighbors.brute_force_knn(n_queries, n_db, n_dims, k, itemsize)``,
    ``neighbors.ivf_search(n_queries, probe_rows, n_dims, k, itemsize[,
    packed_rows])``,
    ``neighbors.ivf_mnmg_search(n_queries, probe_rows, n_dims, k,
    n_ranks, itemsize[, packed_rows])``,
    ``neighbors.ivf_pq_search(n_queries, nprobe, probe_rows, n_dims,
    k, m, n_codes[, itemsize, refine, packed_rows])``,
    ``neighbors.streaming_compact(packed_rows, n_dims, itemsize)``,
    ``linalg.gemm(m, n, k, itemsize[, out_itemsize])``,
    ``sparse.spmv(n_rows, n_cols, nnz, itemsize[, index_itemsize])``."""
    try:
        fn = _ESTIMATORS[op]
    except KeyError:
        raise ValueError(
            f"no footprint estimator for op {op!r}; known: "
            f"{sorted(_ESTIMATORS)}") from None
    return int(fn(**dims))


# Order-of-magnitude sustained throughput by backend: FLOP/s and device
# memory bytes/s. Coarse on purpose: they seed a fast-fail decision (can
# this chunk possibly fit the remaining deadline slack?), never a
# measurement; run_chunked replaces the estimate with measured per-chunk
# wall time after the first launch. The tables live in core/hw.py.
_PEAK_FLOP_S = _hw.SUSTAINED_FLOP_S
_PEAK_BYTES_S = _hw.SUSTAINED_BYTES_S


def _sec_lloyd_step(*, m, k, n_clusters, itemsize=4):
    # fused assignment+update: one [m,k]·[k,K] distance contraction plus
    # the [K,m]·[m,k] update, both passes over X
    flops = 4.0 * m * k * n_clusters
    bytes_ = (m * k + 2.0 * n_clusters * k) * itemsize
    return flops, bytes_


def _sec_lanczos_restart(*, n, ncv, nnz, k=0, itemsize=4):
    # one thick restart: up to ncv extension steps of SpMV (2·nnz) plus
    # two Gram-Schmidt passes (4 matvecs against the [ncv, n] basis),
    # the Ritz back-transform/QR, and the ncv³ projected eigenproblem
    flops = ncv * (2.0 * nnz + 8.0 * n * ncv) + 4.0 * n * ncv * max(k, 1) \
        + 30.0 * ncv ** 3
    bytes_ = ncv * (nnz * (itemsize + 4) + n * ncv * itemsize)
    return flops, bytes_


def _sec_pairwise(*, m, n, k, itemsize):
    # one m×n×k contraction plus the O(m·n) metric epilogue
    flops = 2.0 * m * n * k + 3.0 * m * n
    return flops, _est_pairwise(m=m, n=n, k=k, itemsize=itemsize)


def _sec_knn(*, n_queries, n_db, n_dims, k, itemsize,
             dist_itemsize=4):
    # the full q×db distance block plus the top-k selection
    flops = 2.0 * n_queries * n_db * n_dims \
        + 4.0 * n_queries * n_db
    return flops, _est_knn(n_queries=n_queries, n_db=n_db,
                           n_dims=n_dims, k=k, itemsize=itemsize,
                           dist_itemsize=dist_itemsize)


def _sec_ivf_search(*, n_queries, probe_rows, n_dims, k, itemsize,
                    packed_rows=0, dist_itemsize=4):
    # fine distances over the gathered probe tile plus its top-k
    flops = 2.0 * n_queries * probe_rows * n_dims \
        + 4.0 * n_queries * probe_rows
    return flops, _est_ivf_search(
        n_queries=n_queries, probe_rows=probe_rows, n_dims=n_dims,
        k=k, itemsize=itemsize, packed_rows=packed_rows,
        dist_itemsize=dist_itemsize)


def _sec_ivf_mnmg_search(*, n_queries, probe_rows, n_dims, k, n_ranks,
                         itemsize, packed_rows=0, dist_itemsize=4):
    # per-device cost: the local probe scan plus the replicated
    # [q, n_ranks*k] merge-pool top-k
    flops = 2.0 * n_queries * probe_rows * n_dims \
        + 4.0 * n_queries * (probe_rows + n_ranks * k)
    return flops, _est_ivf_mnmg_search(
        n_queries=n_queries, probe_rows=probe_rows, n_dims=n_dims,
        k=k, n_ranks=n_ranks, itemsize=itemsize,
        packed_rows=packed_rows, dist_itemsize=dist_itemsize)


def _sec_ivf_pq_search(*, n_queries, nprobe, probe_rows, n_dims, k, m,
                       n_codes, itemsize=4, refine=0, packed_rows=0,
                       dist_itemsize=4):
    # the LUT build (one batched residual×codebook contraction), the
    # LUT sum (one code and one LUT entry per candidate and subspace),
    # the top-k, and an armed refine's exact pass over the raw rows
    rr = max(k, refine)
    flops = (2.0 * n_queries * nprobe * n_codes * n_dims
             + 2.0 * n_queries * probe_rows * m
             + 4.0 * n_queries * probe_rows)
    if refine:
        flops += 2.0 * n_queries * rr * n_dims
    return flops, _est_ivf_pq_search(
        n_queries=n_queries, nprobe=nprobe, probe_rows=probe_rows,
        n_dims=n_dims, k=k, m=m, n_codes=n_codes, itemsize=itemsize,
        refine=refine, packed_rows=packed_rows,
        dist_itemsize=dist_itemsize)


def _sec_streaming_compact(*, packed_rows, n_dims, itemsize,
                           id_itemsize=4):
    # bandwidth-bound: the repack streams every packed byte once out and
    # once in; the coarse relabel contraction is the only FLOP term
    flops = 2.0 * packed_rows * n_dims
    return flops, _est_streaming_compact(
        packed_rows=packed_rows, n_dims=n_dims, itemsize=itemsize,
        id_itemsize=id_itemsize)


def _sec_gemm(*, m, n, k, itemsize, out_itemsize=None):
    return 2.0 * m * n * k, _est_gemm(m=m, n=n, k=k,
                                      itemsize=itemsize,
                                      out_itemsize=out_itemsize)


def _sec_spmv(*, n_rows, n_cols, nnz, itemsize, index_itemsize=4):
    return 2.0 * nnz, _est_spmv(n_rows=n_rows, n_cols=n_cols,
                                nnz=nnz, itemsize=itemsize,
                                index_itemsize=index_itemsize)


_SECONDS_ESTIMATORS = {
    "cluster.lloyd_step": _sec_lloyd_step,
    "sparse.lanczos_restart": _sec_lanczos_restart,
    "distance.pairwise_distance": _sec_pairwise,
    "neighbors.brute_force_knn": _sec_knn,
    "neighbors.ivf_search": _sec_ivf_search,
    "neighbors.ivf_mnmg_search": _sec_ivf_mnmg_search,
    "neighbors.ivf_pq_search": _sec_ivf_pq_search,
    "neighbors.streaming_compact": _sec_streaming_compact,
    "linalg.gemm": _sec_gemm,
    "sparse.spmv": _sec_spmv,
}


def _seconds_estimator(op: str):
    try:
        return _SECONDS_ESTIMATORS[op]
    except KeyError:
        raise ValueError(
            f"no seconds estimator for op {op!r}; known: "
            f"{sorted(_SECONDS_ESTIMATORS)}") from None


def estimate_flops_bytes(op: str, **dims) -> tuple:
    """The per-step ``(flops, bytes)`` pair behind
    :func:`estimate_seconds`, so the compiled-driver call sites hand the
    same model costs to the perf-attribution layer
    (``obs.profile_executable`` / ``record_launch``) that seed their
    chunk admission. Same op vocabulary as :func:`estimate_seconds`."""
    flops, bytes_ = _seconds_estimator(op)(**dims)
    return float(flops), float(bytes_)


def estimate_seconds(op: str, *, backend: Optional[str] = None,
                     **dims) -> float:
    """Per-step wall-clock estimate for a compiled chunk's admission
    check, the seconds twin of :func:`estimate_bytes`: the op's inner
    step is costed as ``max(flops/peak_flops, bytes/peak_bandwidth)``
    on ``backend`` (``"gpu"`` or ``"cpu"``; default ``"gpu"`` when CUDA
    is up, else ``"cpu"``) from static shapes only. Known ops:
    ``cluster.lloyd_step(m, k, n_clusters[, itemsize])``,
    ``sparse.lanczos_restart(n, ncv, nnz[, k, itemsize])``, and the ops
    of :func:`estimate_bytes`."""
    fn = _seconds_estimator(op)
    if backend is None:
        backend = _hw.backend_of()
    flops, bytes_ = fn(**dims)
    return max(flops / _PEAK_FLOP_S.get(backend, 5e10),
               bytes_ / _PEAK_BYTES_S.get(backend, 2e10))


def check_chunk_budget(op: str, est_seconds: float) -> None:
    """Pre-launch admission for a compiled chunk: raise
    :class:`DeadlineExceededError` when the chunk's cost estimate
    exceeds the binding deadline's remaining slack, failing BEFORE the
    launch instead of discovering the expiry a whole chunk later. No-op
    without an active deadline scope. Counts into the same breaker and
    ``limits_deadline_exceeded_total`` series as an observed expiry."""
    d = current_deadline()
    if d is None:
        return
    d._ops.add(op)
    rem = d.remaining()
    if est_seconds > rem:
        get_breaker(op).record_failure()
        obs.inc("limits_deadline_exceeded_total", 1, op=op)
        exc = DeadlineExceededError(
            f"{op}: compiled chunk estimated at {est_seconds:.3f}s "
            f"exceeds the {max(rem, 0.0):.3f}s left on the "
            f"{d.budget_s:g}s deadline — failing before launch",
            op=op, budget_s=d.budget_s)
        obs.record_failure(exc)
        raise exc


def admit(op: str, estimate: int, *,
          budget: Optional[WorkBudget] = None) -> bool:
    """Admission check at an instrumented entry point: True when the
    monolithic launch fits (a breaker success), False when over budget
    (the caller degrades or calls :func:`reject`). Raises
    :class:`RejectedError` (``breaker_open``) when the op's breaker is
    fast-failing. With no budget active, always True and no breaker is
    touched."""
    b = budget if budget is not None else active_budget()
    if b is None:
        return True
    br = get_breaker(op)
    if not br.allow():
        obs.inc("limits_rejected_total", 1, reason="breaker_open", op=op)
        exc = RejectedError(
            f"{op}: circuit breaker open after {br.threshold} "
            f"consecutive typed failures (cooldown {br.cooldown_s:g}s)",
            op=op, estimate=int(estimate), reason="breaker_open")
        obs.record_failure(exc)
        raise exc
    if int(estimate) <= b.limit_bytes:
        br.record_success()
        return True
    return False


def reject(op: str, estimate: int, *,
           budget: Optional[WorkBudget] = None,
           detail: str = "") -> None:
    """Refuse the request (even the tiled path cannot fit): a breaker
    failure, ``limits_rejected_total{reason='over_budget'}``, and
    :class:`RejectedError` with the byte estimate."""
    b = budget if budget is not None else active_budget()
    limit = b.limit_bytes if b is not None else None
    get_breaker(op).record_failure()
    obs.inc("limits_rejected_total", 1, reason="over_budget", op=op)
    exc = RejectedError(
        f"{op}: estimated footprint {int(estimate)} bytes exceeds the "
        f"admission budget ({limit} bytes) even for the tiled path"
        + (f"; {detail}" if detail else ""),
        op=op, estimate=int(estimate), budget=limit)
    obs.record_failure(exc)
    raise exc


def record_degraded(op: str) -> None:
    """Count a degraded (row-chunked) execution admission chose instead
    of the monolithic launch."""
    obs.inc("limits_degraded_total", 1, op=op)


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """Consecutive-typed-failure breaker for one op key.

    Closed (normal) until ``threshold`` consecutive failures, then open:
    :meth:`allow` returns False (callers fast-fail with
    ``RejectedError(reason='breaker_open')``) until ``cooldown_s`` has
    elapsed, after which one half-open probe is allowed — a success
    closes the breaker, a failure re-opens it immediately."""

    def __init__(self, op: str, *, threshold: int = BREAKER_THRESHOLD,
                 cooldown_s: float = BREAKER_COOLDOWN_S):
        self.op = op
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._lock = threading.Lock()

    def allow(self) -> bool:
        with self._lock:
            if self._opened_at is None:
                return True
            if time.monotonic() - self._opened_at < self.cooldown_s:
                return False
            # half-open: let one probe through; a failure re-opens
            self._opened_at = None
            self._failures = self.threshold - 1
            self._set_gauge(0)
            return True

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._failures >= self.threshold and self._opened_at is None:
                self._opened_at = time.monotonic()
                self._set_gauge(1)

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._opened_at is not None:
                self._opened_at = None
                self._set_gauge(0)

    @property
    def open(self) -> bool:
        with self._lock:
            return self._opened_at is not None

    def _set_gauge(self, state: int) -> None:
        # called under self._lock; obs is itself thread-safe
        obs.set_gauge("limits_breaker_state", state, op=self.op,
                      help="circuit breaker state (0 closed, 1 open)")


_breakers: Dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def get_breaker(op: str) -> CircuitBreaker:
    """The process-global breaker for an op key (created on first use)."""
    br = _breakers.get(op)
    if br is None:
        with _breakers_lock:
            br = _breakers.setdefault(op, CircuitBreaker(op))
    return br


def reset_breakers() -> None:
    """Drop all breaker state (tests and REPL hygiene)."""
    with _breakers_lock:
        _breakers.clear()


# ---------------------------------------------------------------------------
# rate budgets (retry budgets, hedge budgets)
# ---------------------------------------------------------------------------

class RateBudget:
    """A sliding-window spend budget for *secondary* work — retries,
    hedges — that must never amplify an overload.

    Two modes, one mechanism:

    - **absolute** (``max_events``): at most N spends per ``window_s``.
      The retry-budget shape: a recovering peer sees a bounded retry
      rate no matter how many callers are failing.
    - **fractional** (``max_fraction`` of :meth:`note`-recorded base
      events): spends are capped at a fraction of primary traffic in
      the window. The hedge-budget shape (Dean & Barroso's ≤5%): with
      no primaries there is nothing to hedge against, so the budget is
      empty, and a traffic spike raises the allowance proportionally
      instead of letting hedges pile on a fixed cap.

    Both can be set; the tighter one wins. :meth:`try_spend` is a
    check-and-commit — a True return has already consumed the slot, so
    concurrent spenders can't overshoot."""

    __slots__ = ("max_events", "max_fraction", "window_s",
                 "_base", "_spent", "_lock")

    def __init__(self, *, max_events: Optional[int] = None,
                 max_fraction: Optional[float] = None,
                 window_s: float = 60.0):
        if max_events is None and max_fraction is None:
            raise ValueError(
                "RateBudget needs max_events and/or max_fraction")
        if max_events is not None and max_events < 0:
            raise ValueError(f"max_events must be >= 0, got {max_events}")
        if max_fraction is not None and not (0.0 <= max_fraction <= 1.0):
            raise ValueError(
                f"max_fraction must be in [0, 1], got {max_fraction}")
        if not window_s > 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.max_events = max_events
        self.max_fraction = max_fraction
        self.window_s = float(window_s)
        self._base: "collections.deque" = _collections.deque()
        self._spent: "collections.deque" = _collections.deque()
        self._lock = threading.Lock()

    def _trim(self, now: float) -> None:
        # under self._lock
        cutoff = now - self.window_s
        for dq in (self._base, self._spent):
            while dq and dq[0] < cutoff:
                dq.popleft()

    def note(self, n: int = 1) -> None:
        """Record ``n`` base (primary) events — the denominator for
        ``max_fraction`` mode. No-op cost in absolute mode is fine;
        callers need not branch."""
        if self.max_fraction is None:
            return
        now = time.monotonic()
        with self._lock:
            self._trim(now)
            self._base.extend([now] * int(n))

    def try_spend(self, n: int = 1) -> bool:
        """Atomically consume ``n`` budget slots if the window allows
        it. False means the caller must skip the retry/hedge (and
        should meter the suppression)."""
        n = int(n)
        now = time.monotonic()
        with self._lock:
            self._trim(now)
            spent = len(self._spent)
            if self.max_events is not None \
                    and spent + n > self.max_events:
                return False
            if self.max_fraction is not None:
                allowed = int(len(self._base) * self.max_fraction)
                if spent + n > allowed:
                    return False
            self._spent.extend([now] * n)
            return True

    def spent(self) -> int:
        """Spends currently inside the window (observability/tests)."""
        now = time.monotonic()
        with self._lock:
            self._trim(now)
            return len(self._spent)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"RateBudget(max_events={self.max_events}, "
                f"max_fraction={self.max_fraction}, "
                f"window_s={self.window_s})")
