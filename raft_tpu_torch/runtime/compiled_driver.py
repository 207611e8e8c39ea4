"""Compiled solver inner loops (counterpart of
``raft_tpu/runtime/compiled_driver.py``).

A host-driven solver pays, every iteration, the launches of its torch
ops and a device-to-host read of its convergence test. This module runs
a chunk of iterations with one launch a step and touches the host once a
chunk:

- :class:`ChunkLoop` / :func:`chunk_while`: up to ``steps`` iterations
  of a ``step_fn(carry) -> (carry, done)`` body. On CUDA tensors every
  step is masked: active while ``i < steps`` and the loop is not done;
  an inactive step leaves the carry as it was (``torch.where`` on every
  carry tensor), its gated kernels do no work
  (:func:`raft_tpu_torch.kernels.gated`), and ``ran`` counts the active
  steps on the device. That is the reference's early exit, bit for bit;
  the cost is that the steps after convergence still launch. A run's
  first chunk launches its steps one by one (no host read between them),
  and from its second chunk on a :class:`ChunkLoop` replays one masked
  step captured as a CUDA graph (``torch.cuda.CUDAGraph``) once a step;
  a one-step chunk runs the body itself.
  On CPU tensors the same body runs as a plain Python loop that stops
  when ``done``.
- :func:`run_chunked`: the host half. It drives a chunk program until
  convergence or a step budget, reading the device ONCE per chunk. The
  host's hooks move to the chunk boundary: the checkpoint/health
  ``boundary`` callback (fired BEFORE the deadline poll, so an expiring
  budget always leaves a resumable checkpoint behind), the deadline
  poll, the chunk's admission against the deadline's slack, and the
  guard-mode ``sentinel``. Each boundary records a span, bumps
  ``solver_host_syncs_total`` and emits a ``compiled_driver.chunk``
  trace event.
- :func:`default_sync_every` / :func:`resolve_sync_every`: the chunk
  length: 1 on the CPU (host dispatch is cheap there, and 1 routes
  callers through their host-driven path bit for bit), 8–16 on a CUDA
  card, sized so the per-chunk launch and read stay under ~5% of the
  device work.

A run owns its graph: the caller makes one :class:`ChunkLoop` a run and
hands it to :func:`run_chunked`, so every later chunk of the run, the
tail too, replays the one graph, which goes when the run drops the
loop. The graph bakes in the addresses of the tensors its body reads,
which the body's closure keeps alive for the run. A capture that fails
raises; it never falls back to the eager loop.
Kernel launch counts stay true under replay: a capture's launches are
tallied, not counted, and each replay counts the tally
(:func:`raft_tpu_torch.kernels.count_replay`).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Optional, Tuple

import torch

from raft_tpu_torch import kernels, obs
from raft_tpu_torch.core import hw, trace
from raft_tpu_torch.core.guards import resolve_guard_mode
from raft_tpu_torch.runtime import limits

# Nominal per-launch host overhead (dispatch + small-scalar readback) by
# backend, seconds. It only seeds the cost model; run_chunked refines
# with measured per-chunk wall time.
DISPATCH_OVERHEAD_S = {"gpu": 5e-4, "cpu": 5e-5}

# Accelerator chunk-length clamp: below 8 the per-chunk overhead still
# shows at the north-star shape; above 16 a converged fit wastes up to a
# chunk of dead iterations and deadline granularity degrades.
SYNC_EVERY_LO = 8
SYNC_EVERY_HI = 16

# Fraction of a chunk's device time the per-chunk host overhead is
# allowed to cost before the cost model grows the chunk.
_OVERHEAD_FRAC = 0.05


def host_float_dtype():
    """Accumulator dtype for in-graph convergence scalars: float64, so
    the in-graph test matches the host loops' Python-float arithmetic
    (the card has native f64)."""
    return torch.float64


def default_sync_every(*, step_seconds: Optional[float] = None,
                       backend: Optional[str] = None,
                       device=None) -> int:
    """Pick a chunk length. CPU -> 1 (callers route through their
    host-driven path unchanged). A CUDA card -> the smallest chunk that
    keeps the per-launch overhead under ~5% of device work, clamped to
    [8, 16]; with no step estimate, the top of the clamp. ``backend``
    (``"gpu"`` or ``"cpu"``) defaults to ``device``'s (``cuda`` ->
    ``"gpu"``), else to ``"gpu"`` when CUDA is up."""
    backend = backend or hw.backend_of(device)
    if backend == "cpu":
        return 1
    overhead = DISPATCH_OVERHEAD_S.get(backend, 1e-3)
    if step_seconds is None or step_seconds <= 0.0:
        return SYNC_EVERY_HI
    n = math.ceil(overhead / (_OVERHEAD_FRAC * step_seconds))
    return max(SYNC_EVERY_LO, min(SYNC_EVERY_HI, n))


def resolve_sync_every(sync_every: Optional[int], *,
                       step_seconds: Optional[float] = None,
                       backend: Optional[str] = None,
                       device=None) -> int:
    """Validate an explicit ``sync_every`` or fall back to the cost
    model. Every chunked entry point funnels through here so the
    default policy has one spelling."""
    if sync_every is None:
        return default_sync_every(step_seconds=step_seconds,
                                  backend=backend, device=device)
    n = int(sync_every)
    if n < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    return n


# ---------------------------------------------------------------------------
# chunk_while: a Python loop on the CPU, a captured graph on the card
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_streams: dict = {}
_stats = {"captures": 0, "replays": 0, "steps_launched": 0,
          "host_reads": 0}


class _State:
    """A run's loop state on the card: the carry, the step counter, the
    done flag and the step bound, as buffers that each masked step reads
    and writes back (so a graph of the step can replay over them)."""

    __slots__ = ("carry", "i", "done", "steps_in")

    def __init__(self, carry: tuple):
        dev = carry[0].device
        self.carry = tuple(torch.empty_like(t) for t in carry)
        self.i = torch.zeros((), dtype=torch.int32, device=dev)
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.steps_in = torch.zeros((), dtype=torch.int32, device=dev)

    def load(self, carry: tuple, steps: int) -> None:
        for dst, src in zip(self.carry, carry):
            dst.copy_(src)
        self.i.zero_()
        self.done.zero_()
        self.steps_in.fill_(steps)


def _as_tuple(carry):
    if isinstance(carry, torch.Tensor):
        return (carry,), True
    return tuple(carry), False


def _stream(dev: torch.device) -> torch.cuda.Stream:
    """The device's stream for chunks: a run's first chunk launches its
    steps there, which warms the libraries' state on the stream that
    captures, and every replay runs there."""
    s = _streams.get(dev)
    if s is None:
        s = _streams[dev] = torch.cuda.Stream(dev)
    return s


def _masked_step(step_fn, st: _State, single: bool) -> None:
    """One step over the state: active while ``i < steps`` and not done
    (an inactive one keeps the carry, and its gated kernels do no work),
    then the state written back into its buffers."""
    active = (st.i < st.steps_in) & ~st.done
    with kernels.gated(active.to(torch.int32)):
        new, d = step_fn(st.carry[0] if single else st.carry)
    new, _ = _as_tuple(new)
    cur = tuple(torch.where(active, n, o) for n, o in zip(new, st.carry))
    if not isinstance(d, torch.Tensor):
        d = torch.full((), bool(d), dtype=torch.bool, device=st.i.device)
    done = torch.where(active, d.to(torch.bool), st.done)
    i = st.i + active.to(torch.int32)
    for buf, t in zip(st.carry + (st.i, st.done), cur + (i, done)):
        buf.copy_(t)


def _capture(step_fn, st: _State, single: bool):
    """A CUDA graph of one masked step over ``st``, and its kernel-launch
    tally. Runs on the device's chunk stream."""
    graph = torch.cuda.CUDAGraph()
    with kernels.capture_launches() as tally:
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            _masked_step(step_fn, st, single)
        except BaseException:
            try:
                graph.capture_end()
            except Exception:
                pass
            raise
        graph.capture_end()
    with _lock:
        _stats["captures"] += 1
    return graph, dict(tally)


class ChunkLoop:
    """:func:`chunk_while` bound to one step body for one run; call it
    as ``loop(carry, steps) -> (carry, ran, done)``, the chunk program
    :func:`run_chunked` takes.

    On CUDA tensors the run's first chunk launches its masked steps one
    by one (no host read between them), which also loads the kernels'
    modules and the libraries' handles; the second captures one masked
    step as a CUDA graph, and that chunk and every later one replay it
    once a step. A run that converges in its first chunk captures
    nothing, and a one-step chunk runs the body itself. The graph lives
    as long as the loop. On CPU tensors each chunk is a Python loop that
    stops when ``done``."""

    def __init__(self, step_fn: Callable[[Any], Tuple[Any, Any]]):
        self.step_fn = step_fn
        self._state: Optional[_State] = None
        self._graph = None
        self._tally: dict = {}

    def __call__(self, carry, steps) -> Tuple[Any, Any, Any]:
        tup, single = _as_tuple(carry)
        n = int(steps)
        if n < 0:
            raise ValueError(f"steps must be >= 0, got {steps}")
        dev = tup[0].device
        if dev.type != "cuda":
            ran, done = 0, False
            while ran < n and not done:
                carry, d = self.step_fn(carry)
                done = bool(d)
                ran += 1
            return (carry, torch.tensor(ran, dtype=torch.int32),
                    torch.tensor(done))
        if any(t.device != dev for t in tup):
            raise ValueError("chunk_while: carry on different devices")
        if n == 1:
            # a one-step chunk is the body itself (sync_every=1 is the
            # host loop)
            carry, d = self.step_fn(carry)
            if not isinstance(d, torch.Tensor):
                d = torch.full((), bool(d), device=dev)
            with _lock:
                _stats["steps_launched"] += 1
            return (carry, torch.ones((), dtype=torch.int32, device=dev),
                    d.to(torch.bool))
        cur, side = torch.cuda.current_stream(dev), _stream(dev)
        side.wait_stream(cur)
        with torch.cuda.device(dev), torch.cuda.stream(side):
            out = self._chunk(tup, n, single)
        cur.wait_stream(side)
        carry_out, ran, done = out
        return (carry_out[0] if single else carry_out), ran, done

    def _chunk(self, tup: tuple, n: int, single: bool):
        first = self._state is None
        if first:
            self._state = _State(tup)
        st = self._state
        st.load(tup, n)
        if first:
            for _ in range(n):
                _masked_step(self.step_fn, st, single)
        else:
            if self._graph is None:
                try:
                    self._graph, self._tally = _capture(self.step_fn, st,
                                                        single)
                except Exception as exc:
                    raise RuntimeError(
                        f"compiled_driver: CUDA graph capture of "
                        f"{self.step_fn!r} failed: {exc}") from exc
            for _ in range(n):
                self._graph.replay()
                kernels.count_replay(self._tally)
        with _lock:
            _stats["steps_launched"] += n
            if not first:
                _stats["replays"] += n
        return (tuple(t.clone() for t in st.carry), st.i.clone(),
                st.done.clone())


def chunk_while(step_fn: Callable[[Any], Tuple[Any, Any]], carry,
                steps) -> Tuple[Any, Any, Any]:
    """Run up to ``steps`` iterations of ``step_fn``.

    ``step_fn(carry) -> (carry, done)``, ``carry`` a tensor or a tuple of
    tensors; the loop stops once ``done`` goes true, and a converged
    chunk leaves the carry as the converging step left it. Returns
    ``(carry, ran, done)`` with ``ran`` (int32) the number of body
    executions and ``done`` (bool), both 0-d tensors on the carry's
    device. One chunk of a fresh :class:`ChunkLoop` (on the card, its
    steps launched one by one); a run of many chunks makes one loop, so
    its later chunks replay a captured graph."""
    return ChunkLoop(step_fn)(carry, steps)


def graph_stats() -> dict:
    """Counts since the last :func:`reset_graph_stats`: graphs captured,
    replays, steps launched on the card (a run's first chunk's and every
    replay, the masked ones too), and :func:`run_chunked`'s host reads
    (one a chunk)."""
    with _lock:
        return dict(_stats)


def reset_graph_stats() -> None:
    """Zero :func:`graph_stats`."""
    with _lock:
        for k in _stats:
            _stats[k] = 0


# ---------------------------------------------------------------------------
# run_chunked: the host half
# ---------------------------------------------------------------------------


def run_chunked(chunk_call: Callable, carry, *, max_steps: int,
                sync_every: int, op: str, steps_done: int = 0,
                est_step_seconds: Optional[float] = None,
                step_flops: Optional[float] = None,
                step_bytes: Optional[float] = None,
                boundary: Optional[Callable] = None,
                sentinel: Optional[Callable] = None):
    """Drive a chunk program to convergence or ``max_steps``.

    ``chunk_call(carry, steps) -> (carry, ran, done)`` is the caller's
    chunk (typically :func:`chunk_while`); ``ran``/``done`` are device
    scalars and fetching them is THE host read of the chunk. Per
    boundary, in order:

    1. ``boundary(carry, steps_done, done)``: checkpoint then health
       probe, the host loop's ordering: the checkpoint lands before
       anything below can raise, so deadline expiry leaves a resumable
       file.
    2. ``limits.check_deadline(op)``: the deadline poll.
    3. ``limits.check_chunk_budget``: fail BEFORE launching a chunk
       whose estimated cost exceeds the remaining slack
       (``est_step_seconds`` seeds the estimate; measured per-chunk
       wall time refines it).
    4. the launch, under the ``op + ".chunk"`` span, and the one host
       read of ``(ran, done)``;
    5. ``record_launch``, ``record_hbm_watermark``,
       ``solver_host_syncs_total``, the ``compiled_driver.chunk`` trace
       event and the ``deadline_slack_seconds`` histogram;
    6. ``sentinel(carry, steps_done)``: the guard-mode numeric check,
       only when guards are armed (only ``off`` is ported, so it never
       fires yet).

    With ``RAFT_TPU_PERF=on`` and per-step model costs (``step_flops``
    / ``step_bytes``), each chunk's measured wall time feeds the roofline
    attribution under the ``(op, "chunk")`` profile key, and the device
    memory watermark is polled at each boundary. Off (the default) both
    are single-bool no-ops.

    Returns ``(carry, steps_done, done)``. ``steps_done`` starts at the
    caller's offset so a resumed fit keeps global iteration counts.
    """
    if step_flops or step_bytes:
        obs.profile_executable(op, "chunk",
                               model_flops=step_flops or 0.0,
                               model_bytes=step_bytes or 0.0)
    armed = sentinel is not None and resolve_guard_mode() != "off"
    device = _as_tuple(carry)[0][0].device
    done = False
    per_step = est_step_seconds
    while True:
        if boundary is not None:
            boundary(carry, steps_done, done)
        limits.check_deadline(op)
        if done or steps_done >= max_steps:
            return carry, steps_done, done
        n = min(int(sync_every), max_steps - steps_done)
        if per_step is not None and per_step > 0.0:
            limits.check_chunk_budget(op, per_step * n)
        t0 = time.monotonic()
        with obs.span(op + ".chunk", steps=n) as sp:
            carry, ran_d, done_d = chunk_call(carry, n)
            # the chunk's single host read
            ran, flag = torch.stack((ran_d.to(torch.int64),
                                     done_d.to(torch.int64))).tolist()
            done = bool(flag)
            with _lock:
                _stats["host_reads"] += 1
            sp.set_attr(ran=ran, wall_s=round(time.monotonic() - t0, 6))
        wall = time.monotonic() - t0
        steps_done += ran
        if ran > 0:
            per_step = wall / ran     # measured refinement of the model
            obs.record_launch(op, "chunk", wall, steps=ran)
        obs.record_hbm_watermark(device)
        obs.inc("solver_host_syncs_total", 1, op=op)
        trace.record_event("compiled_driver.chunk", op=op, steps=ran,
                           done=bool(done))
        rem = limits.remaining()
        if rem is not None and obs.enabled():
            obs.observe("deadline_slack_seconds", max(rem, 0.0),
                        help="time left on the binding deadline at a "
                             "compiled-chunk boundary (seconds)")
        if armed:
            sentinel(carry, steps_done)
