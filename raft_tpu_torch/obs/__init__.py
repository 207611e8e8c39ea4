"""Observability of the port (counterpart of ``raft_tpu/obs``), with
every name of the reference's ``__all__``.

:mod:`raft_tpu_torch.obs.metrics`
    labeled Counter/Gauge/Histogram registry behind the
    ``RAFT_TPU_METRICS=off|on`` toggle (off, the default, makes every
    emit helper a no-op behind one bool check), and
    ``record_convergence``, the solvers' epilogue hook.
:mod:`raft_tpu_torch.obs.spans`
    recorded host-side regions on the ``core/trace.py`` range stack, and
    manufactured ones (``record_span``).
:mod:`raft_tpu_torch.obs.export`
    the process-wide event ring ``trace.record_event`` feeds, the JSONL
    sink, ``snapshot()``, the Prometheus text exposition and the
    chrome://tracing exporter.
:mod:`raft_tpu_torch.obs.tracectx`
    request-scoped :class:`TraceContext`, propagated thread-locally and
    across the host mailbox's ranks (``RAFT_TPU_TRACING``).
:mod:`raft_tpu_torch.obs.flight`
    the always-on failure flight recorder, ``record_failure(exc)``.
:mod:`raft_tpu_torch.obs.perf`
    performance attribution: per-executable model costs turned at launch
    time into achieved FLOP/s, bytes/s and roofline-fraction gauges
    against the :mod:`raft_tpu_torch.core.hw` peak table, device-memory
    watermarks and ``profile_session`` (span-aligned ``torch.profiler``
    capture). ``RAFT_TPU_PERF=off`` (the default) keeps every helper a
    single-bool no-op.
:mod:`raft_tpu_torch.obs.schema`
    validators of the JSONL stream, flight bundles and chrome traces.
"""

from raft_tpu_torch.obs.metrics import (    # noqa: F401
    enabled, set_enabled, MetricsRegistry, get_registry, set_registry,
    log_buckets, DEFAULT_BUCKETS, RESIDUAL_BUCKETS,
    inc, set_gauge, observe, record_convergence,
)
from raft_tpu_torch.obs.spans import (      # noqa: F401
    span, spans, clear_spans, record_span, set_sample_rate,
    set_retention, ring_stats,
)
from raft_tpu_torch.obs.export import (     # noqa: F401
    emit_event, events, clear_events,
    JsonlSink, get_sink, set_sink,
    snapshot, render_prometheus, render_chrome_trace,
)
from raft_tpu_torch.obs.tracectx import (   # noqa: F401
    TraceContext, tracing_enabled, set_tracing, mint,
    current_context, use_context, adopt,
)
from raft_tpu_torch.obs.flight import (     # noqa: F401
    record_failure, flight_bundles, clear_flight_bundles,
    set_flight_dir, flight_dir,
)
from raft_tpu_torch.obs.perf import (       # noqa: F401
    ExecutableProfile, perf_enabled, set_perf_enabled,
    profile_executable, record_launch, record_hbm_watermark,
    profile_session, perf_profiles, clear_perf_profiles, perf_snapshot,
)

__all__ = [
    "enabled", "set_enabled", "MetricsRegistry", "get_registry",
    "set_registry", "log_buckets", "DEFAULT_BUCKETS", "RESIDUAL_BUCKETS",
    "inc", "set_gauge", "observe", "record_convergence",
    "span", "spans", "clear_spans", "record_span", "set_sample_rate",
    "set_retention", "ring_stats",
    "emit_event", "events", "clear_events",
    "JsonlSink", "get_sink", "set_sink",
    "snapshot", "render_prometheus", "render_chrome_trace",
    "TraceContext", "tracing_enabled", "set_tracing", "mint",
    "current_context", "use_context", "adopt",
    "record_failure", "flight_bundles", "clear_flight_bundles",
    "set_flight_dir", "flight_dir",
    "ExecutableProfile", "perf_enabled", "set_perf_enabled",
    "profile_executable", "record_launch", "record_hbm_watermark",
    "profile_session", "perf_profiles", "clear_perf_profiles",
    "perf_snapshot",
]
