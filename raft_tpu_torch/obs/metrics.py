"""Thread-safe metrics registry: labeled Counter / Gauge / Histogram.

Design mirrors the Prometheus client-library data model (families of
labeled series; histograms carry per-bucket counts plus ``sum`` and
``count``) without taking the dependency, and the guard-mode philosophy
of :mod:`raft_tpu_torch.core.guards`:

``RAFT_TPU_METRICS=off`` (default)
    emission is a no-op behind a single module-level bool check —
    instrumented ops are bit-identical to the uninstrumented library and
    the hot path allocates nothing (no label tuples, no locks taken).
``RAFT_TPU_METRICS=on``
    series are created lazily on first emission; every mutation happens
    under the owning family's lock, so concurrent emitters (the comms
    server thread, heartbeat thread, and solver driver) never lose
    increments.

Cardinality is bounded per family (``max_series``, default 64): once a
family is full, emissions with novel label values collapse into a single
``<overflow>`` series and the family counts the drop — a misbehaving
label (say, a peer address) degrades metrics, never memory.

Histogram buckets are fixed and log-spaced (:func:`log_buckets`); the
default span (1 µs … 1000 s at two buckets per decade) covers collective
latencies, compile times, and checkpoint writes. Convergence residuals
use the wider :data:`RESIDUAL_BUCKETS` (1e-14 … 1e2).
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

from raft_tpu_torch.core import env as _env_mod

__all__ = [
    "enabled", "set_enabled", "MetricsRegistry",
    "get_registry", "set_registry",
    "log_buckets", "DEFAULT_BUCKETS", "RESIDUAL_BUCKETS",
    "inc", "set_gauge", "observe", "record_convergence",
]


# ---------------------------------------------------------------------------
# the on/off knob (pattern: guards.RAFT_TPU_GUARD_MODE — env read once at
# import, bad values warn and fall back to the safe default)
# ---------------------------------------------------------------------------

_enabled = _env_mod.read("RAFT_TPU_METRICS")


def enabled() -> bool:
    """True when metric/span emission is live (``RAFT_TPU_METRICS=on``).

    Instrumentation sites gate on this: when False the emit helpers
    return before touching any lock or allocating any label tuple."""
    return _enabled


def set_enabled(on: bool) -> None:
    """Flip metric emission at runtime (tests; long-lived services that
    want to arm metrics after warmup)."""
    global _enabled
    _enabled = bool(on)


# ---------------------------------------------------------------------------
# buckets
# ---------------------------------------------------------------------------

def log_buckets(lo: float, hi: float, per_decade: int = 2
                ) -> Tuple[float, ...]:
    """Fixed log-spaced histogram bucket upper bounds covering
    ``[lo, hi]`` with ``per_decade`` buckets per factor of 10. The
    implicit ``+Inf`` bucket is NOT included (histograms add it)."""
    if not (lo > 0 and hi > lo):
        raise ValueError("want 0 < lo < hi")
    if per_decade < 1:
        raise ValueError("per_decade must be >= 1")
    n = int(round(math.log10(hi / lo) * per_decade))
    out = [lo * 10.0 ** (i / per_decade) for i in range(n + 1)]
    # round to a stable short decimal so bucket labels are reproducible
    return tuple(float(f"{b:.6g}") for b in out)


#: 1 µs … 1000 s — latencies, compile seconds, checkpoint writes.
DEFAULT_BUCKETS = log_buckets(1e-6, 1e3, per_decade=2)

#: 1e-14 … 100 — convergence residuals (relative measures near eps64).
RESIDUAL_BUCKETS = log_buckets(1e-14, 1e2, per_decade=1)

_OVERFLOW = "<overflow>"


# ---------------------------------------------------------------------------
# series (children)
# ---------------------------------------------------------------------------

class _Series:
    __slots__ = ("labels",)

    def __init__(self, labels: Tuple[str, ...]):
        self.labels = labels


class Counter(_Series):
    """Monotonically increasing value. ``inc`` with a negative amount
    raises — counters only go up (rate() must be meaningful)."""

    __slots__ = ("_family", "value")

    def __init__(self, family, labels):
        super().__init__(labels)
        self._family = family
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not _enabled:
            return
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._family._lock:
            self.value += amount


class Gauge(_Series):
    """Point-in-time value (queue depths, live peer counts)."""

    __slots__ = ("_family", "value")

    def __init__(self, family, labels):
        super().__init__(labels)
        self._family = family
        self.value = 0.0

    def set(self, value: float) -> None:
        if not _enabled:
            return
        with self._family._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not _enabled:
            return
        with self._family._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class Histogram(_Series):
    """Fixed-bucket histogram: per-bucket observation counts plus sum
    and count (Prometheus semantics; cumulative ``le`` series are
    materialized at render time, not stored)."""

    __slots__ = ("_family", "bucket_counts", "sum", "count")

    def __init__(self, family, labels):
        super().__init__(labels)
        self._family = family
        # one slot per finite bound + the +Inf slot
        self.bucket_counts = [0] * (len(family.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        if not _enabled:
            return
        value = float(value)
        if not math.isfinite(value):
            # non-finite observations land in +Inf and poison the sum;
            # count them where they are at least visible
            idx = len(self._family.buckets)
            with self._family._lock:
                self.bucket_counts[idx] += 1
                self.count += 1
            return
        idx = bisect.bisect_left(self._family.buckets, value)
        with self._family._lock:
            self.bucket_counts[idx] += 1
            self.sum += value
            self.count += 1


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


# ---------------------------------------------------------------------------
# families
# ---------------------------------------------------------------------------

class _Family:
    """All series of one metric name: one kind, one labelname schema,
    one lock, one cardinality budget."""

    def __init__(self, kind: str, name: str, help: str,
                 labelnames: Tuple[str, ...], max_series: int,
                 buckets: Optional[Tuple[float, ...]] = None):
        self.kind = kind
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self.max_series = max_series
        self.buckets = buckets or ()
        self.dropped = 0          # emissions rerouted to <overflow>
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Series] = {}

    def labels(self, **labels) -> _Series:
        """The series for these label values, created on first use.

        Label names must match the family schema exactly. Past the
        cardinality cap, novel label values collapse into one
        ``<overflow>`` series (and ``dropped`` counts the reroutes)."""
        if tuple(sorted(labels)) != self.labelnames:
            raise ValueError(
                f"metric {self.name!r} expects labels "
                f"{self.labelnames}, got {tuple(sorted(labels))}")
        key = tuple(str(labels[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= self.max_series:
                    self.dropped += 1
                    key = (_OVERFLOW,) * len(self.labelnames)
                    child = self._children.get(key)
                    if child is None:
                        child = _KINDS[self.kind](self, key)
                        self._children[key] = child
                else:
                    child = _KINDS[self.kind](self, key)
                    self._children[key] = child
        return child

    def series(self) -> Iterable[_Series]:
        with self._lock:
            return list(self._children.values())


class MetricsRegistry:
    """Thread-safe home of all metric families.

    ``counter`` / ``gauge`` / ``histogram`` get-or-create a family;
    re-registration with a different kind, labelname schema, or bucket
    layout raises (one name means one thing process-wide)."""

    def __init__(self, max_series_per_family: int = 64):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        self.max_series_per_family = int(max_series_per_family)

    # -- family constructors ------------------------------------------------

    def _family(self, kind: str, name: str, help: str,
                labelnames: Sequence[str],
                buckets: Optional[Sequence[float]] = None) -> _Family:
        labelnames = tuple(sorted(labelnames))
        bkts = tuple(buckets) if buckets is not None else None
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                if kind == "histogram":
                    bkts = bkts or DEFAULT_BUCKETS
                    if list(bkts) != sorted(bkts):
                        raise ValueError("buckets must be sorted")
                fam = _Family(kind, name, help, labelnames,
                              self.max_series_per_family, bkts)
                self._families[name] = fam
                return fam
        if fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}, "
                f"not {kind}")
        if fam.labelnames != labelnames:
            raise ValueError(
                f"metric {name!r} already registered with labels "
                f"{fam.labelnames}, not {labelnames}")
        if kind == "histogram" and bkts is not None \
                and tuple(fam.buckets) != bkts:
            raise ValueError(
                f"metric {name!r} already registered with different "
                "buckets")
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> _Family:
        return self._family("counter", name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> _Family:
        return self._family("gauge", name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> _Family:
        return self._family("histogram", name, help, labelnames, buckets)

    # -- introspection ------------------------------------------------------

    def families(self) -> Dict[str, _Family]:
        with self._lock:
            return dict(self._families)

    def snapshot(self) -> dict:
        """JSON-able dump of every family and series (the dict behind
        :func:`raft_tpu_torch.obs.export.snapshot`)."""
        out: dict = {}
        for name, fam in sorted(self.families().items()):
            with fam._lock:
                series = []
                for child in fam._children.values():
                    entry: dict = {
                        "labels": dict(zip(fam.labelnames, child.labels))}
                    if fam.kind == "histogram":
                        entry["buckets"] = dict(
                            zip([str(b) for b in fam.buckets] + ["+Inf"],
                                list(child.bucket_counts)))
                        entry["sum"] = child.sum
                        entry["count"] = child.count
                    else:
                        entry["value"] = child.value
                    series.append(entry)
                out[name] = {"type": fam.kind, "help": fam.help,
                             "labelnames": list(fam.labelnames),
                             "dropped_series": fam.dropped,
                             "series": series}
        return out

    def reset(self) -> None:
        """Drop every family (tests)."""
        with self._lock:
            self._families.clear()


# ---------------------------------------------------------------------------
# process-global default registry + emit helpers (the ONLY API
# instrumented modules use)
# ---------------------------------------------------------------------------

_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default_registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry (tests); returns the old one."""
    global _default_registry
    old, _default_registry = _default_registry, registry
    return old


def inc(name: str, amount: float = 1.0, help: str = "",
        **labels) -> None:
    """Increment counter ``name`` (created on first use). No-op when
    metrics are off."""
    if not _enabled:
        return
    _default_registry.counter(
        name, help, tuple(labels)).labels(**labels).inc(amount)


def set_gauge(name: str, value: float, help: str = "", **labels) -> None:
    """Set gauge ``name``. No-op when metrics are off."""
    if not _enabled:
        return
    _default_registry.gauge(
        name, help, tuple(labels)).labels(**labels).set(value)


def observe(name: str, value: float, help: str = "",
            buckets: Optional[Sequence[float]] = None, **labels) -> None:
    """Observe ``value`` into histogram ``name``. No-op when metrics are
    off."""
    if not _enabled:
        return
    _default_registry.histogram(
        name, help, tuple(labels), buckets).labels(**labels).observe(value)


def record_convergence(op: str, report) -> None:
    """Feed a :class:`~raft_tpu_torch.core.guards.ConvergenceReport` into
    the solver metric families: the one hook every iterative solver's
    epilogue calls (k-means, Lanczos)."""
    if not _enabled or report is None:
        return
    inc("solver_iterations_total", max(0, int(report.n_iter)),
        help="iterations spent by iterative solvers", solver=op)
    inc("solver_runs_total", 1,
        help="solver invocations by convergence outcome", solver=op,
        converged=str(bool(report.converged)).lower())
    observe("solver_residual",
            float(report.residual),
            help="final convergence residual per solver run",
            buckets=RESIDUAL_BUCKETS, solver=op)
    if getattr(report, "breakdowns", 0):
        inc("solver_breakdowns_total", int(report.breakdowns),
            help="internally recovered solver breakdown events",
            solver=op)
    if getattr(report, "escalated", False):
        inc("solver_escalations_total", 1,
            help="solver runs that used precision escalation", solver=op)
