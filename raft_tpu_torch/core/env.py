"""Registry of the ``RAFT_TPU_*`` environment knobs the port reads.

The same contract as ``raft_tpu/core/env.py``: every knob is declared
here with its parser, default and malformed-value policy, and read
through :func:`read`; library code never reads ``os.environ`` for a
``RAFT_TPU_*`` key itself. An empty string counts as unset.

``on_malformed="raise"``
    a malformed value raises ``ValueError`` naming the variable, at the
    read site (import time for the knobs read at import), so a typo'd
    limit never silently becomes a default;
``on_malformed="warn"``
    observability and guard toggles warn and fall back to their default:
    a typo takes down the feature, not the process.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict

__all__ = ["EnvVar", "register", "registry", "read", "parse_bytes",
           "PRECISION_ALIASES"]

# Tier spellings accepted by RAFT_TPU_MATMUL_PRECISION and
# util.precision.set_matmul_precision (the reference package's aliases).
PRECISION_ALIASES = {
    "default": "default", "fastest": "default", "bfloat16": "default",
    "high": "high", "bfloat16_3x": "high", "tensorfloat32": "high",
    "highest": "highest", "float32": "highest", "f32": "highest",
}


# -- parsers ----------------------------------------------------------------

def _parse_str(raw: str) -> str:
    return raw


def _parse_lower(raw: str) -> str:
    return raw.lower()


def _parse_onoff(raw: str) -> bool:
    """The metrics/tracing toggle spelling: on/1/true/yes vs
    off/0/false/no."""
    low = raw.lower()
    if low in ("on", "1", "true", "yes"):
        return True
    if low in ("off", "0", "false", "no"):
        return False
    raise ValueError(f"want one of on|off|1|0|true|false|yes|no, "
                     f"got {raw!r}")


def _parse_flag(raw: str) -> bool:
    """Loose boolean, as the reference package reads it: anything but
    0/false is on."""
    return raw.lower() not in ("0", "false")


def _parse_pos_int(raw: str) -> int:
    try:
        val = int(raw)
    except ValueError:
        raise ValueError(f"{raw!r} is not an integer") from None
    if val < 1:
        raise ValueError(f"{raw!r} must be >= 1")
    return val


def _parse_rate(raw: str) -> float:
    try:
        rate = float(raw)
    except ValueError:
        raise ValueError(f"{raw!r} is not a number") from None
    if not (0.0 <= rate <= 1.0):
        raise ValueError(f"{raw!r} must be in [0, 1]")
    return rate


def _parse_float(raw: str) -> float:
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{raw!r} is not a number") from None


def _parse_pos_float(raw: str) -> float:
    try:
        val = float(raw)
    except ValueError:
        raise ValueError(f"{raw!r} is not a number") from None
    if not val > 0.0:
        raise ValueError(f"{raw!r} must be > 0")
    return val


def _parse_ratio_ge1(raw: str) -> float:
    """A trigger ratio: a float >= 1.0 (1.0 = trigger immediately)."""
    try:
        val = float(raw)
    except ValueError:
        raise ValueError(f"{raw!r} is not a number") from None
    if not val >= 1.0:
        raise ValueError(f"ratio must be >= 1.0, got {raw!r}")
    return val


def _parse_precision(raw: str) -> str:
    canon = PRECISION_ALIASES.get(raw.lower())
    if canon is None:
        raise ValueError(f"want one of {sorted(set(PRECISION_ALIASES))}, "
                         f"got {raw!r}")
    return canon


def _parse_peaks(raw: str) -> Dict[str, float]:
    """``flops=<num>,bytes=<num>`` device-peak override terms (either
    term may be omitted; at least one must be present, both positive)."""
    out: Dict[str, float] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        key, sep, val = part.partition("=")
        key = key.strip().lower()
        if not sep or key not in ("flops", "bytes"):
            raise ValueError(
                f"want 'flops=<num>,bytes=<num>' terms, got {part!r}")
        try:
            num = float(val)
        except ValueError:
            raise ValueError(f"{val!r} is not a number") from None
        if not num > 0.0:
            raise ValueError(f"{key} peak must be positive, got {val!r}")
        out[key] = num
    if not out:
        raise ValueError(
            "want at least one 'flops=<num>' or 'bytes=<num>' term")
    return out


def _choice(*options: str) -> Callable[[str], str]:
    def parse(raw: str) -> str:
        low = raw.lower()
        if low not in options:
            raise ValueError(f"want one of {'|'.join(options)}, "
                             f"got {raw!r}")
        return low
    return parse


_BYTE_SUFFIX = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_bytes(text, *, name: str = "byte count") -> int:
    """Parse a byte count: a plain number or a number with a k/m/g/t
    binary suffix (``"512m"``, ``"2g"``). Raises ``ValueError`` on
    anything else, so a typo'd limit never silently becomes unlimited.
    ``runtime.limits.parse_bytes`` is this function."""
    s = str(text).strip().lower()
    mult = 1
    if s and s[-1] in _BYTE_SUFFIX:
        mult = _BYTE_SUFFIX[s[-1]]
        s = s[:-1]
    try:
        val = float(s)
    except ValueError:
        raise ValueError(
            f"{name} must be a byte count (optionally with a k/m/g/t "
            f"suffix, e.g. '512m'), got {text!r}") from None
    n = int(val * mult)
    if n <= 0:
        raise ValueError(f"{name} must be positive, got {text!r}")
    return n


# -- registry ---------------------------------------------------------------

@dataclass(frozen=True)
class EnvVar:
    """One declared knob: how to parse it and what a bad value does."""

    name: str
    parse: Callable[[str], Any]
    default: Any
    on_malformed: str               # "raise" | "warn"
    help: str = ""


_REGISTRY: Dict[str, EnvVar] = {}
_UNSET = object()


def register(name: str, parse: Callable[[str], Any], default: Any = None,
             *, on_malformed: str = "raise", help: str = "") -> EnvVar:
    if not name.startswith("RAFT_TPU_"):
        raise ValueError(f"env registry is for RAFT_TPU_* knobs, "
                         f"got {name!r}")
    if on_malformed not in ("raise", "warn"):
        raise ValueError(f"on_malformed must be raise|warn, "
                         f"got {on_malformed!r}")
    spec = EnvVar(name, parse, default, on_malformed, help)
    _REGISTRY[name] = spec
    return spec


def registry() -> Dict[str, EnvVar]:
    """Snapshot of every declared knob."""
    return dict(_REGISTRY)


def read(name: str, default: Any = _UNSET) -> Any:
    """Read and parse one registered knob. Unset or empty returns the
    default (the registered one, or the call site's); a malformed value
    raises ``ValueError`` naming the variable, or for an
    ``on_malformed="warn"`` knob warns and returns the default; an
    unregistered name raises ``KeyError``."""
    spec = _REGISTRY.get(name)
    if spec is None:
        raise KeyError(f"{name} is not a registered knob; declare it in "
                       f"raft_tpu_torch/core/env.py")
    fallback = spec.default if default is _UNSET else default
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return fallback
    try:
        return spec.parse(raw)
    except ValueError as e:
        if spec.on_malformed == "warn":
            warnings.warn(f"{name}={raw!r} is invalid ({e}); using "
                          f"{fallback!r}", stacklevel=2)
            return fallback
        raise ValueError(f"{name}: {e}") from None


# -- the knob table ---------------------------------------------------------
# Observability and guard toggles: degrade to their default with a warning.
register("RAFT_TPU_METRICS", _parse_onoff, False, on_malformed="warn",
         help="arm the metrics/span subsystem (off = single-bool no-op)")
register("RAFT_TPU_TRACING", _parse_onoff, False, on_malformed="warn",
         help="mint + propagate request TraceContexts")
register("RAFT_TPU_GUARD_MODE", _choice("off", "check", "recover"), "off",
         on_malformed="warn",
         help="numerical sentinel mode (core/guards.py)")
register("RAFT_TPU_LOG_LEVEL", _parse_lower, "warn", on_malformed="warn",
         help="raft_tpu logger level; unknown names fall back to warn "
              "(core/logger.py owns the level table)")
register("RAFT_TPU_DEBUG_LOG_FILE", _parse_str, None, on_malformed="warn",
         help="route the raft_tpu logger to a file instead of stderr")
register("RAFT_TPU_METRICS_JSONL", _parse_str, None, on_malformed="warn",
         help="auto-attach a JSONL metrics sink at import (metrics on)")
register("RAFT_TPU_FLIGHT_DIR", _parse_str, None, on_malformed="warn",
         help="on-disk flight-recorder bundle directory")
register("RAFT_TPU_PERF", _parse_onoff, False, on_malformed="warn",
         help="arm per-executable performance attribution "
              "(obs/perf.py roofline telemetry); off = single-bool "
              "no-op, bit-identical")
# Overload-resilience toggles: degrade to the conservative setting (on)
# with a warning, so resilience does not vanish on a typo.
register("RAFT_TPU_BROWNOUT", _parse_onoff, True, on_malformed="warn",
         help="arm the adaptive quality-brownout controller "
              "(serve/brownout.py); off = always full quality")
register("RAFT_TPU_HEDGE", _parse_onoff, True, on_malformed="warn",
         help="arm hedged re-issue in ReplicaGroup.submit "
              "(serve/replica.py); off = single dispatch")

# Fail-loud knobs: malformed raises at the read site.
register("RAFT_TPU_MATMUL_PRECISION", _parse_precision, "high",
         help="matmul precision tier; see util/precision.py")
register("RAFT_TPU_SPARSE_PAD", _parse_flag, True,
         help="pad CSR indices/data to an nnz size class in from_scipy "
              "(core/sparse_types.py); changes the physical nnz")
register("RAFT_TPU_HBM_BUDGET", _parse_str, None,
         help="process-wide device-memory admission budget; parsed by "
              "limits.parse_bytes (k/m/g/t suffixes) and raises at "
              "import on a malformed value")
register("RAFT_TPU_RECV_TIMEOUT", _parse_float, None,
         help="default blocking-recv deadline (s) of the host mailbox")
register("RAFT_TPU_SPAN_RETAIN", _parse_pos_int, 2048,
         help="span ring retention (newest N spans)")
register("RAFT_TPU_SPAN_SAMPLE", _parse_rate, 1.0,
         help="span sampling rate in [0, 1] (counter-stride, "
              "deterministic)")
register("RAFT_TPU_PERF_PEAKS", _parse_peaks, None,
         help="override the core/hw.py device-peak table: "
              "'flops=<num>,bytes=<num>' per-second peaks (either term "
              "alone overrides just that axis); malformed raises at the "
              "read site")

# Streaming-index knobs (neighbors/streaming.py, neighbors/scrub.py):
# fail loud, as the reference's. A typo'd threshold must not become
# "never compact" or "always compact", a typo'd retention must not keep
# everything or one epoch, and a typo'd scrub interval must not switch
# the at-rest checks off.
register("RAFT_TPU_COMPACT_TOMBSTONE_FRAC", _parse_rate, 0.25,
         help="tombstone (and tail-full) fraction in [0, 1] at which the "
              "background compactor repacks the streaming index")
register("RAFT_TPU_COMPACT_INTERVAL", _parse_pos_float, 0.25,
         help="background compactor poll interval in seconds (> 0)")
register("RAFT_TPU_DRIFT_THRESHOLD", _parse_ratio_ge1, 2.0,
         help="refit the coarse quantizer when the EMA of ingested rows' "
              "nearest-centroid distance exceeds this multiple of the "
              "build-time baseline (>= 1.0)")
register("RAFT_TPU_WAL_RETAIN", _parse_pos_int, 2,
         help="epoch snapshots the streaming MutationLog keeps (>= 1); "
              "older ones and the WAL records they fold are pruned at "
              "each epoch commit")
register("RAFT_TPU_SCRUB_INTERVAL", _parse_pos_float, 1.0,
         help="background scrubber pass interval in seconds (> 0)")
