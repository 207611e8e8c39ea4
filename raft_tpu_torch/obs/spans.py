"""Structured spans: named host-side regions
with monotonic start/duration, parented off the existing
:mod:`raft_tpu_torch.core.trace` range stack.

``trace.push_range`` is the NVTX analogue — it marks a region for Xprof
but records nothing the host can query afterwards. A span is the
recorded counterpart: entering one pushes the name onto the same
thread-local range stack (so nested ranges, spans, and
``trace.record_event`` events all attribute consistently), and exiting
appends a completed-span record to a bounded in-memory ring and to the
JSONL sink when one is attached (:mod:`raft_tpu_torch.obs.export`).

Cost model matches the metrics registry: with ``RAFT_TPU_METRICS=off``
:func:`span` returns a shared null context manager — no allocation, no
range-stack push, bit-identical behavior.

Retention and sampling are bounded by construction:

* the ring keeps the newest ``RAFT_TPU_SPAN_RETAIN`` spans (default
  2048) — observability, not an audit log;
* ``RAFT_TPU_SPAN_SAMPLE`` (a rate in (0, 1], default 1.0) keeps
  deterministically every ``round(1/rate)``-th span per name — a
  counter-stride, not a coin flip, so runs are reproducible.

Both env knobs fail loud: a malformed or out-of-range value raises
``ValueError`` at import (the policy of ``RAFT_TPU_RECV_TIMEOUT``
and ``RAFT_TPU_HBM_BUDGET`` — a typo'd retention silently falling back
to the default is a debugging session, not a convenience).

When tracing is on (:mod:`raft_tpu_torch.obs.tracectx`), a span entered under
an active :class:`TraceContext` records ``trace_id`` / ``request_id`` /
``tenant`` as top-level record keys, so a span ring (or flight bundle,
or chrome trace) can be sliced by request.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Deque, Dict, List, Optional

from raft_tpu_torch.core import env as _env_mod
from raft_tpu_torch.obs import metrics as _metrics
from raft_tpu_torch.obs import tracectx as _tracectx

__all__ = ["span", "spans", "clear_spans", "record_span",
           "set_sample_rate", "set_retention", "ring_stats"]

_lock = threading.Lock()
_counts: Dict[str, int] = {}      # per-name emission counter (sampling)

# Loss accounting: a truncated flight bundle must
# be distinguishable from a quiet system, so the ring counts what it
# sheds — spans evicted by retention (_dropped) and spans the
# counter-stride never admitted (_sampled_out). obs.snapshot() surfaces
# both.
_dropped = 0
_sampled_out = 0


# Both knobs are fail-loud at import (matching RAFT_TPU_RECV_TIMEOUT /
# RAFT_TPU_HBM_BUDGET): a malformed retention or sample rate raises
# rather than silently keeping the default.
_spans: Deque[dict] = collections.deque(
    maxlen=_env_mod.read("RAFT_TPU_SPAN_RETAIN"))
_sample_stride = (
    0 if (_r := _env_mod.read("RAFT_TPU_SPAN_SAMPLE")) == 0.0
    else max(1, int(round(1.0 / _r))))


def set_sample_rate(rate: float) -> None:
    """Keep every ``round(1/rate)``-th span per name (rate in [0, 1];
    0 drops all spans)."""
    global _sample_stride
    rate = float(rate)
    if not (0.0 <= rate <= 1.0):
        raise ValueError("sample rate must be in [0, 1]")
    _sample_stride = 0 if rate == 0.0 else max(1, int(round(1.0 / rate)))


def set_retention(maxlen: int) -> None:
    """Resize the in-memory span ring (drops current contents)."""
    global _spans
    with _lock:
        _spans = collections.deque(maxlen=max(1, int(maxlen)))


class _NullSpan:
    """Zero-cost stand-in when metrics are off (shared singleton)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attr(self, **attrs) -> None:
        pass


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "parent", "t_start", "duration",
                 "_thread", "_ctx")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.parent: Optional[str] = None
        self.t_start = 0.0
        self.duration = 0.0
        self._thread = None
        self._ctx = None

    def set_attr(self, **attrs) -> None:
        """Attach attributes discovered mid-span (iteration counts,
        byte totals)."""
        self.attrs.update(attrs)

    def __enter__(self):
        from raft_tpu_torch.core import trace
        self.parent = trace.current_range()
        self._thread = threading.get_ident()
        if _tracectx.tracing_enabled():
            self._ctx = _tracectx.current_context()
        trace._stack().append(self.name)
        self.t_start = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.duration = time.monotonic() - self.t_start
        from raft_tpu_torch.core import trace
        st = trace._stack()
        if st and st[-1] == self.name:
            st.pop()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        _record(self)
        return False


def _record(sp: _Span) -> None:
    global _sampled_out, _dropped
    with _lock:
        n = _counts.get(sp.name, 0) + 1
        _counts[sp.name] = n
        if _sample_stride == 0 or (n - 1) % _sample_stride != 0:
            _sampled_out += 1
            return
        rec = {"name": sp.name, "t": sp.t_start,
               "duration": sp.duration, "parent": sp.parent,
               "thread": sp._thread, "attrs": dict(sp.attrs)}
        if sp._ctx is not None:
            rec.update(sp._ctx.attrs())
        if len(_spans) == _spans.maxlen:
            _dropped += 1
        _spans.append(rec)
    # sink write happens outside the span lock (the sink has its own)
    from raft_tpu_torch.obs import export
    export._sink_span(rec)


def record_span(name: str, *, t_start: float, duration: float,
                parent: Optional[str] = None,
                thread: Optional[int] = None,
                ctx: Optional["_tracectx.TraceContext"] = None,
                **attrs) -> Optional[dict]:
    """Record a manufactured span: one whose lifetime was measured
    outside a ``with`` block (a profiler session, per-request slices
    derived after a batch launch completes).

    No-op (returns None) when metrics are off. Not subject to
    counter-stride sampling: manufactured spans are explicit, their
    caller already decided they matter. ``ctx`` defaults to the calling
    thread's active :class:`TraceContext`."""
    if not _metrics.enabled():
        return None
    if ctx is None and _tracectx.tracing_enabled():
        ctx = _tracectx.current_context()
    rec = {"name": name, "t": float(t_start),
           "duration": float(duration), "parent": parent,
           "thread": thread if thread is not None
           else threading.get_ident(),
           "attrs": dict(attrs)}
    if ctx is not None:
        rec.update(ctx.attrs())
    global _dropped
    with _lock:
        if len(_spans) == _spans.maxlen:
            _dropped += 1
        _spans.append(rec)
    from raft_tpu_torch.obs import export
    export._sink_span(rec)
    return rec


def span(name: str, **attrs):
    """Context manager recording a completed span on exit.

    Returns a shared no-op object when metrics are off; the recorded
    span's parent is the innermost :func:`raft_tpu_torch.core.trace.push_range`
    range (or enclosing span) at entry time."""
    if not _metrics.enabled():
        return _NULL
    return _Span(name, dict(attrs))


def spans(name: Optional[str] = None) -> List[dict]:
    """Snapshot of retained spans, newest last; optionally filtered by
    span name."""
    with _lock:
        out = list(_spans)
    if name is None:
        return out
    return [s for s in out if s["name"] == name]


def ring_stats() -> dict:
    """Retention/loss accounting for the span ring: spans currently
    retained, spans evicted by the retention bound since the last
    :func:`clear_spans`, and spans the sampling stride never admitted.
    ``dropped``/``sampled_out`` nonzero means the ring (and any flight
    bundle snapshotting it) is a truncated view, not a quiet system."""
    with _lock:
        return {"retained": len(_spans), "dropped": _dropped,
                "sampled_out": _sampled_out}


def clear_spans() -> None:
    global _dropped, _sampled_out
    with _lock:
        _spans.clear()
        _counts.clear()
        _dropped = 0
        _sampled_out = 0
