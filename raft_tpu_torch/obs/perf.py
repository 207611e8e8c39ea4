"""Performance attribution (counterpart of ``raft_tpu/obs/perf.py``):
per-executable static costs, achieved-throughput roofline telemetry, and
aligned device profiling.

The request-level layers (metrics, spans, tracing, flight) answer *what
happened*; this module answers *how fast*, in the spirit of the Roofline
model (Williams et al., CACM 2009):

* **Static costs at warm time.** :func:`profile_executable` registers
  an :class:`ExecutableProfile` keyed ``(op, bucket)`` (the compiled
  driver's chunks use bucket ``"chunk"``), holding the executable's
  FLOPs and bytes per step. They come from the caller's model numbers,
  the same ``limits.estimate_flops_bytes`` cost model the admission
  layer trusts (source ``"model"``). The reference can instead ask XLA's
  ``cost_analysis()`` of a traced ``fn``/``example`` pair; a CUDA
  kernel has no such analysis, so the port accepts the pair and keeps
  the model costs, the reference's own fallback.
* **Achieved throughput at launch time.** :func:`record_launch`
  converts a wall time the compiled driver already measures into
  achieved FLOP/s, bytes/s, and a roofline fraction against
  :func:`raft_tpu_torch.core.hw.peaks`, classifying each launch as
  ``compute`` / ``bandwidth`` / ``overhead`` bound and emitting
  ``perf_roofline_frac{op,bucket,bound}``,
  ``perf_achieved_flops_per_s`` and ``perf_achieved_bytes_per_s``
  gauges through the one obs registry.
* **Device-memory watermarks.** :func:`record_hbm_watermark` polls
  ``torch.cuda.memory_allocated`` / ``max_memory_allocated`` (through
  :func:`raft_tpu_torch.core.memory.device_memory_stats`; compiled-driver
  chunk boundaries call it) into ``perf_hbm_bytes_in_use`` /
  ``perf_hbm_peak_bytes_in_use``.
* **Aligned device profiles.** :func:`profile_session` wraps
  ``torch.profiler`` around the body, writes its chrome trace under the
  log directory, and records a ``perf.profile_session`` span over the
  same monotonic clock the span ring uses, so the device profile lines
  up with host spans in :func:`raft_tpu_torch.obs.render_chrome_trace`.

``RAFT_TPU_PERF=off`` (the default) makes every helper here a
single-bool no-op. The knob is independent of ``RAFT_TPU_METRICS``:
profiles accumulate whenever perf is on, gauges additionally publish
when metrics are on too.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from raft_tpu_torch.core import env as _env_mod
from raft_tpu_torch.core import hw as _hw
from raft_tpu_torch.obs import metrics as _metrics

__all__ = [
    "ExecutableProfile", "perf_enabled", "set_perf_enabled",
    "profile_executable", "record_launch", "record_hbm_watermark",
    "profile_session", "perf_profiles", "clear_perf_profiles",
    "perf_snapshot",
]

# the single-bool switch (same discipline as metrics._enabled)
_enabled: bool = _env_mod.read("RAFT_TPU_PERF")

# a launch whose modeled device time explains less than this fraction
# of its wall time spent the wall on dispatch/queueing/capture, not the
# device: classified "overhead" rather than compute/bandwidth bound
OVERHEAD_FRAC = 0.1

_lock = threading.Lock()
_profiles: Dict[Tuple[str, Any], "ExecutableProfile"] = {}
_peaks: Optional[_hw.HwPeaks] = None
_hbm: Dict[str, int] = {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                        "polls": 0}


def perf_enabled() -> bool:
    return _enabled


def set_perf_enabled(on: bool) -> bool:
    """Flip performance attribution at runtime (the programmatic twin
    of ``RAFT_TPU_PERF``); returns the previous state."""
    global _enabled
    prev, _enabled = _enabled, bool(on)
    return prev


@dataclass
class ExecutableProfile:
    """Static costs + running achieved-throughput attribution for one
    executable. ``flops``/``bytes`` are per launch at scale 1 (per chunk
    *step* for the compiled-driver entries)."""

    op: str
    bucket: Any                      # serve row bucket, or "chunk"
    flops: float = 0.0
    bytes: float = 0.0
    source: str = "model"
    launches: int = 0
    wall_s: float = 0.0              # cumulative measured wall
    steps: float = 0.0               # cumulative launch scale
    achieved_flops_per_s: float = 0.0
    achieved_bytes_per_s: float = 0.0
    roofline_frac: float = 0.0
    bound: str = ""                  # "compute"|"bandwidth"|"overhead"
    attrs: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"op": self.op, "bucket": self.bucket,
                "flops": self.flops, "bytes": self.bytes,
                "source": self.source, "launches": self.launches,
                "wall_s": round(self.wall_s, 6),
                "achieved_flops_per_s": self.achieved_flops_per_s,
                "achieved_bytes_per_s": self.achieved_bytes_per_s,
                "roofline_frac": self.roofline_frac,
                "bound": self.bound, **self.attrs}


def _device_peaks() -> _hw.HwPeaks:
    global _peaks
    pk = _peaks
    if pk is None:
        pk = _peaks = _hw.peaks()
    return pk


def reset_peaks() -> None:
    """Drop the cached peak table (tests that flip the env override)."""
    global _peaks
    _peaks = None


def profile_executable(op: str, bucket, *, fn=None, example=None,
                       model_flops: float = 0.0,
                       model_bytes: float = 0.0,
                       **attrs) -> Optional[ExecutableProfile]:
    """Register (or refresh) the static-cost profile for one
    ``(op, bucket)`` executable. No-op returning None when perf is off.

    The costs are the ``model_*`` numbers from the limits cost models.
    ``fn``/``example`` (the reference's XLA cost-analysis pair) are
    accepted for its callers and not read: a hand-written kernel has no
    compiler cost analysis, so every profile's source is ``"model"``."""
    if not _enabled:
        return None
    key = (op, bucket)
    with _lock:
        prof = _profiles.get(key)
        if prof is None:
            prof = _profiles[key] = ExecutableProfile(op, bucket)
        prof.flops, prof.bytes = float(model_flops), float(model_bytes)
        prof.source = "model"
        prof.attrs.update(attrs)
    return prof


def record_launch(op: str, bucket, wall_s: float, *,
                  steps: float = 1.0) -> Optional[ExecutableProfile]:
    """Attribute one measured launch to its profile: achieved FLOP/s,
    bytes/s, roofline fraction, and a compute/bandwidth/overhead bound
    classification, published as gauges. ``steps`` scales the static
    per-launch costs (the compiled driver passes the number of solver
    iterations its chunk ran). No-op when perf is off; ignores launches
    with no registered profile or a non-positive wall."""
    if not _enabled:
        return None
    wall_s = float(wall_s)
    if wall_s <= 0.0:
        return None
    with _lock:
        prof = _profiles.get((op, bucket))
        if prof is None:
            return None
        flops = prof.flops * steps
        bytes_ = prof.bytes * steps
        prof.launches += 1
        prof.wall_s += wall_s
        prof.steps += steps
        prof.achieved_flops_per_s = flops / wall_s
        prof.achieved_bytes_per_s = bytes_ / wall_s
        pk = _device_peaks()
        t_f = flops / pk.flops_per_s if pk.flops_per_s > 0 else 0.0
        t_b = bytes_ / pk.bytes_per_s if pk.bytes_per_s > 0 else 0.0
        t_dev = max(t_f, t_b)
        frac = t_dev / wall_s
        prof.roofline_frac = frac
        if t_dev < OVERHEAD_FRAC * wall_s:
            bound = "overhead"
        elif t_f >= t_b:
            bound = "compute"
        else:
            bound = "bandwidth"
        prof.bound = bound
    lbl = str(bucket)
    _metrics.set_gauge("perf_roofline_frac", frac,
                       help="achieved fraction of the binding roofline "
                            "ceiling for the last launch",
                       op=op, bucket=lbl, bound=bound)
    _metrics.set_gauge("perf_achieved_flops_per_s",
                       prof.achieved_flops_per_s,
                       help="achieved FLOP/s over the last launch",
                       op=op, bucket=lbl)
    _metrics.set_gauge("perf_achieved_bytes_per_s",
                       prof.achieved_bytes_per_s,
                       help="achieved HBM bytes/s over the last launch",
                       op=op, bucket=lbl)
    return prof


def record_hbm_watermark(device=None) -> Optional[dict]:
    """Poll live/peak device memory into gauges (the compiled driver
    calls this at chunk boundaries). No-op when perf is off; never
    raises: a device without counters (the CPU) reports zeros, and one
    that cannot be read (no CUDA) returns None."""
    if not _enabled:
        return None
    from raft_tpu_torch.core.memory import device_memory_stats

    try:
        stats = device_memory_stats(device)
    except Exception:
        return None
    with _lock:
        _hbm["bytes_in_use"] = int(stats["bytes_in_use"])
        _hbm["peak_bytes_in_use"] = max(
            _hbm["peak_bytes_in_use"], int(stats["peak_bytes_in_use"]))
        _hbm["polls"] += 1
    _metrics.set_gauge("perf_hbm_bytes_in_use", stats["bytes_in_use"],
                       help="live HBM bytes in use at the last "
                            "chunk-boundary poll")
    _metrics.set_gauge("perf_hbm_peak_bytes_in_use",
                       stats["peak_bytes_in_use"],
                       help="runtime-reported peak HBM bytes in use")
    return stats


@contextlib.contextmanager
def profile_session(log_dir: Optional[str] = None):
    """Capture a device profile aligned with the span ring.

    Runs the body under ``torch.profiler`` (CPU activity, and CUDA's when
    CUDA is up), writes the capture as ``trace.json`` under ``log_dir``
    (a fresh temp dir when none is given), and records a
    ``perf.profile_session`` span over the same monotonic clock every
    other span uses, so the capture and the host timeline
    ``obs.render_chrome_trace`` exports line up by the session's
    start/duration. Yields the log directory, or None when perf is off
    (the whole manager is then a no-op) or the profiler refuses to start
    (the body still runs; only the device capture is lost)."""
    if not _enabled:
        yield None
        return
    import os

    if log_dir is None:
        import tempfile

        log_dir = tempfile.mkdtemp(prefix="raft_tpu_torch_profile_")
    prof = None
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception:
        prof = None
    t0 = time.monotonic()
    try:
        yield log_dir if prof is not None else None
    finally:
        dur = time.monotonic() - t0
        if prof is not None:
            with contextlib.suppress(Exception):
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(str(log_dir),
                                                      "trace.json"))
        from raft_tpu_torch.obs.spans import record_span as _record_span
        _record_span("perf.profile_session", t_start=t0,
                     duration=dur, log_dir=str(log_dir),
                     captured=prof is not None)


def perf_profiles() -> Dict[Tuple[str, Any], ExecutableProfile]:
    """Snapshot of the live profile registry (the objects themselves,
    read-only by convention)."""
    with _lock:
        return dict(_profiles)


def clear_perf_profiles() -> None:
    """Drop all profiles and device-memory watermarks."""
    with _lock:
        _profiles.clear()
        _hbm.update(bytes_in_use=0, peak_bytes_in_use=0, polls=0)


def perf_snapshot() -> dict:
    """JSON-able view for ``obs.snapshot()``'s ``"perf"`` section:
    enabled flag, the peak table in force, every profile, and the
    device-memory watermark. Cheap when off: no device inspection,
    empty tables."""
    if not _enabled:
        return {"enabled": False, "profiles": {}, "hbm": dict(_hbm)}
    pk = _device_peaks()
    with _lock:
        profs = {f"{op}[{bucket}]": p.as_dict()
                 for (op, bucket), p in _profiles.items()}
        hbm = dict(_hbm)
    return {"enabled": True,
            "peaks": {"name": pk.name, "flops_per_s": pk.flops_per_s,
                      "bytes_per_s": pk.bytes_per_s,
                      "source": pk.source},
            "profiles": profs, "hbm": hbm}
