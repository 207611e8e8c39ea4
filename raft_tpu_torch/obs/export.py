"""Export surface (counterpart of ``raft_tpu/obs/export.py``): the
process-wide event ring, the JSONL sink, :func:`snapshot`, the
Prometheus text exposition (:func:`render_prometheus`) and the
chrome://tracing / Perfetto exporter (:func:`render_chrome_trace`).

:func:`raft_tpu_torch.core.trace.record_event` feeds the ring: one
record per event with ``name``/``range``/``range_stack``/``t`` and the
event's attributes. The ring is always on, not gated by
``RAFT_TPU_METRICS``: it is the library's error-path observability. A
JSONL sink, when attached (:func:`set_sink`), also gets each event and
each completed span as one JSON object per line with ``kind``
(``"event"`` | ``"span"``), ``ts`` (wall clock) and ``t`` (monotonic).
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import threading
import time
from typing import Deque, List, Optional

from raft_tpu_torch.obs import metrics as _metrics
from raft_tpu_torch.obs import tracectx as _tracectx

__all__ = [
    "emit_event", "events", "clear_events",
    "JsonlSink", "get_sink", "set_sink",
    "snapshot", "render_prometheus", "render_chrome_trace",
]


# ---------------------------------------------------------------------------
# JSONL sink
# ---------------------------------------------------------------------------

def _json_safe(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    try:                       # np scalars and friends
        return v.item()
    except (AttributeError, ValueError):
        return repr(v)


class JsonlSink:
    """Thread-safe JSON-lines writer (one event per line, flushed so a
    crash loses at most the line being written)."""

    def __init__(self, target):
        """``target`` is a path (opened for append) or a file-like
        object with ``write``/``flush``."""
        self._lock = threading.Lock()
        self._closed = False
        if isinstance(target, (str, bytes)) or hasattr(target, "__fspath__"):
            self._fh = open(target, "a", encoding="utf-8")
            self._owns = True
        else:
            self._fh = target
            self._owns = False

    def write(self, record: dict) -> None:
        line = json.dumps(_json_safe(record), separators=(",", ":"))
        with self._lock:
            if self._closed:
                return
            self._fh.write(line + "\n")
            self._fh.flush()

    def flush(self) -> None:
        with self._lock:
            if not self._closed:
                self._fh.flush()

    def close(self) -> None:
        """Flush and (when this sink opened the file) close it.
        Idempotent — safe to call from both user code and the atexit
        hook."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            # underlying stream may already be closed at interpreter exit
            with contextlib.suppress(ValueError):
                self._fh.flush()
            if self._owns:
                self._fh.close()


_sink_lock = threading.Lock()
_sink: Optional[JsonlSink] = None


def get_sink() -> Optional[JsonlSink]:
    return _sink


def set_sink(sink: Optional[JsonlSink]) -> Optional[JsonlSink]:
    """Install (or with None, detach) the process JSONL sink; returns
    the previous sink (caller owns closing it)."""
    global _sink
    with _sink_lock:
        old, _sink = _sink, sink
    return old


# ---------------------------------------------------------------------------
# the unified event ring (rehomed from core/trace.py; record shape is
# frozen — trace.events() consumers depend on it)
# ---------------------------------------------------------------------------

_events_lock = threading.Lock()
_events: Deque[dict] = collections.deque(maxlen=1024)
# ring-overwrite counter: events evicted by the bounded ring since the
# last clear_events(), so a truncated event history is distinguishable
# from a quiet one
_events_overwritten = 0


def emit_event(name: str, **attrs) -> None:
    """Record an instantaneous host-side event in the active range.

    Always appends to the bounded in-memory ring (the pre-obs
    ``trace.record_event`` contract); additionally writes a
    ``kind="event"`` JSONL line when a sink is attached."""
    from raft_tpu_torch.core import trace
    ev = {"name": name, "range": trace.current_range(),
          "range_stack": tuple(trace.range_stack()),
          "t": time.monotonic()}
    if _tracectx.tracing_enabled():
        ctx = _tracectx.current_context()
        if ctx is not None:
            ev.update(ctx.attrs())
    ev.update(attrs)
    global _events_overwritten
    with _events_lock:
        if len(_events) == _events.maxlen:
            _events_overwritten += 1
        _events.append(ev)
    sink = _sink
    if sink is not None:
        rec = dict(ev)
        rec["kind"] = "event"
        rec["ts"] = time.time()
        sink.write(rec)


def events(name: Optional[str] = None) -> List[dict]:
    """Snapshot of recorded events, newest last; optionally filtered by
    event name."""
    with _events_lock:
        evs = list(_events)
    if name is None:
        return evs
    return [e for e in evs if e["name"] == name]


def clear_events() -> None:
    global _events_overwritten
    with _events_lock:
        _events.clear()
        _events_overwritten = 0


def _sink_span(rec: dict) -> None:
    """Fan a completed span out to the JSONL sink (spans.py calls this;
    the in-memory retention lives there)."""
    sink = _sink
    if sink is None:
        return
    out = dict(rec)
    out["kind"] = "span"
    out["ts"] = time.time()
    sink.write(out)


# ---------------------------------------------------------------------------
# snapshot + Prometheus text exposition
# ---------------------------------------------------------------------------

def snapshot(registry: Optional[_metrics.MetricsRegistry] = None) -> dict:
    """One JSON-able dict of everything: enabled flag, every metric
    family/series, span/event ring occupancy *and loss counters* (a
    truncated flight bundle must be distinguishable from a quiet
    system), and the performance-attribution section
    (:mod:`raft_tpu_torch.obs.perf`)."""
    from raft_tpu_torch.obs import perf as _perf
    from raft_tpu_torch.obs.spans import ring_stats as _ring_stats
    reg = registry or _metrics.get_registry()
    st = _ring_stats()
    with _events_lock:
        ev_retained, ev_overwritten = len(_events), _events_overwritten
    return {
        "enabled": _metrics.enabled(),
        "metrics": reg.snapshot(),
        "spans_retained": st["retained"],
        "spans_dropped": st["dropped"],
        "spans_sampled_out": st["sampled_out"],
        "events_retained": ev_retained,
        "events_overwritten": ev_overwritten,
        "perf": _perf.perf_snapshot(),
    }


def _esc_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _fmt_labels(names, values) -> str:
    if not names:
        return ""
    inner = ",".join(f'{k}="{_esc_label(str(v))}"'
                     for k, v in zip(names, values))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(
        registry: Optional[_metrics.MetricsRegistry] = None) -> str:
    """Prometheus text exposition (version 0.0.4) of the registry:
    ``# HELP`` / ``# TYPE`` headers, one line per series, histograms as
    cumulative ``_bucket{le=...}`` plus ``_sum`` / ``_count``."""
    reg = registry or _metrics.get_registry()
    out = io.StringIO()
    for name, fam in sorted(reg.families().items()):
        if fam.help:
            out.write(f"# HELP {name} {fam.help}\n")
        out.write(f"# TYPE {name} {fam.kind}\n")
        with fam._lock:
            children = list(fam._children.values())
        for child in sorted(children, key=lambda c: c.labels):
            lbl = _fmt_labels(fam.labelnames, child.labels)
            if fam.kind != "histogram":
                out.write(f"{name}{lbl} {_fmt_value(child.value)}\n")
                continue
            cum = 0
            for bound, n in zip(list(fam.buckets) + ["+Inf"],
                                child.bucket_counts):
                cum += n
                blbl = _fmt_labels(
                    list(fam.labelnames) + ["le"],
                    list(child.labels) + [bound])
                out.write(f"{name}_bucket{blbl} {cum}\n")
            out.write(f"{name}_sum{lbl} {_fmt_value(child.sum)}\n")
            out.write(f"{name}_count{lbl} {child.count}\n")
    return out.getvalue()


# ---------------------------------------------------------------------------
# chrome://tracing / Perfetto exporter
# ---------------------------------------------------------------------------

_CHROME_TRACE_FIELDS = ("trace_id", "request_id", "tenant")


def render_chrome_trace(path: Optional[str] = None, *,
                        spans: Optional[List[dict]] = None) -> dict:
    """Render the span ring as a Perfetto / ``chrome://tracing`` JSON
    document.

    Every span record becomes a ``"ph": "X"`` complete duration event:
    host monotonic seconds scaled to the microseconds the format wants,
    keyed on the recorded thread id so nesting within a thread renders
    as the stack it was. ``*.chunk`` spans (the compiled driver's chunk
    launches) additionally emit an async ``"b"``/``"e"`` slice pair,
    which Perfetto draws as a separate device lane. Trace-context
    fields and span attrs land in ``args``.

    ``spans`` overrides the ring (e.g. a flight bundle's span list);
    ``path`` additionally writes the JSON document to a file. Returns
    the document either way."""
    import os as _os

    recs = spans if spans is not None else _list_all_spans()
    pid = _os.getpid()
    out: List[dict] = []
    async_id = 0
    for rec in recs:
        args = dict(rec.get("attrs") or {})
        if rec.get("parent"):
            args["parent"] = rec["parent"]
        for f in _CHROME_TRACE_FIELDS:
            if rec.get(f):
                args[f] = rec[f]
        ts_us = float(rec["t"]) * 1e6
        dur_us = max(0.0, float(rec["duration"])) * 1e6
        out.append({
            "name": rec["name"], "ph": "X", "cat": "host",
            "ts": ts_us, "dur": dur_us, "pid": pid,
            "tid": rec.get("thread") or 0,
            "args": _json_safe(args),
        })
        if rec["name"].endswith(".chunk"):
            # device lane: one async slice per chunk
            async_id += 1
            base = {"name": rec["name"], "cat": "device",
                    "id": async_id, "pid": pid, "tid": 0,
                    "args": _json_safe(args)}
            out.append({**base, "ph": "b", "ts": ts_us})
            out.append({**base, "ph": "e", "ts": ts_us + dur_us})
    doc = {"traceEvents": out, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, separators=(",", ":"))
    return doc


def _list_all_spans() -> List[dict]:
    from raft_tpu_torch.obs.spans import spans as _list_spans
    return _list_spans()
