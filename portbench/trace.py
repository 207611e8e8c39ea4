"""The traced window: ``torch.profiler`` over it, reduced to what the
per-layer readers and the result's ``breakdown`` need.

The benchmark marks its own calls into the program with
``record_function`` spans (:func:`span`, which remembers each name it
is given) and the whole window with ``"window"``. The device's
operations are the trace's CUDA events, less the device-side copies of
host ranges: a CUDA event that bears the name of a host event of the
same trace (a ``record_function`` range, the benchmark's or the
program's) is such a copy and no operation. Busy time is the union of
the device operations' intervals inside the window; an idle gap is a
stretch of the window with none, named by the innermost benchmark span
the host was in at its middle.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
import sys
from typing import Dict, Iterable, List, Optional, Tuple

import torch

WINDOW = "window"
OUTSIDE = "outside the benchmark's spans"

Interval = Tuple[str, float, float]         # (name, start_us, end_us)


@dataclasses.dataclass
class TraceSummary:
    device: List[Interval]                  # device ops inside the window
    spans: List[Interval]                   # the benchmark's host spans
    window_us: Tuple[float, float]
    busy_us: float

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return self.busy_us / 1e6

    def device_seconds(self, select=None) -> float:
        """Summed device seconds of the ops ``select(name)`` keeps (all
        by default)."""
        return sum(e - s for n, s, e in self.device
                   if select is None or select(n)) / 1e6

    def kernel_seconds(self, names: Iterable[str], metric: str
                       ) -> Optional[float]:
        """Summed device seconds of the kernels named ``names`` (a
        template instance's name carries its arguments, so a name is
        matched as a word of the op's name); None, said on standard
        error for ``metric``, when none of them ran in the window."""
        names = sorted(set(names))
        pattern = re.compile(r"\b(" + "|".join(map(re.escape, names))
                             + r")\b")
        seconds = self.device_seconds(lambda n: bool(pattern.search(n)))
        if seconds <= 0:
            print(f"{metric}: none of the kernels {names} ran in the "
                  f"traced window; the metric is left out",
                  file=sys.stderr)
            return None
        return seconds

    def top_ops(self, limit: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:limit]

    def idle_gaps(self, limit: int = 10) -> List[list]:
        """Idle seconds summed by what the host was doing, largest
        first."""
        by: Dict[str, float] = {}
        spans = sorted(self.spans, key=lambda sp: sp[1])
        starts = [sp[1] for sp in spans]
        for s, e in gaps(self.device, *self.window_us):
            label = label_at(spans, starts, (s + e) / 2)
            by[label] = by.get(label, 0.0) + (e - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:limit]


def merged(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of ``(name, start, end)`` intervals clipped to
    [lo, hi], as sorted disjoint ``(start, end)`` pairs."""
    out: List[Tuple[float, float]] = []
    for _, s, e in sorted(intervals, key=lambda iv: iv[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy(intervals, lo: float, hi: float) -> float:
    return sum(e - s for s, e in merged(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    out, at = [], lo
    for s, e in merged(intervals, lo, hi):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def label_at(spans: List[Interval], starts: List[float], t: float,
             look_back: int = 8) -> str:
    """The innermost (shortest) benchmark span holding ``t``, among the
    ``look_back`` spans that start last before it (``spans`` sorted by
    start, ``starts`` their starts): the benchmark's spans follow one
    another and do not nest deeply."""
    best: Optional[Interval] = None
    hi = bisect.bisect_right(starts, t)
    for sp in spans[max(0, hi - look_back):hi]:
        if t <= sp[2] and (best is None or
                           sp[2] - sp[1] < best[2] - best[1]):
            best = sp
    return best[0] if best is not None else OUTSIDE


@contextlib.contextmanager
def profiled():
    """Run the body under ``torch.profiler`` (CPU and CUDA); yields a
    holder whose ``summary`` is filled when the body ends."""
    from torch.profiler import ProfilerActivity, profile

    holder = _Holder()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield holder
    holder.summary = summarize(prof)


class _Holder:
    summary: Optional[TraceSummary] = None


def summarize(prof) -> TraceSummary:
    """Device ops and benchmark spans from a finished profile."""
    from torch.autograd import DeviceType

    return summarize_events(
        ((ev.name(), ev.device_type() == DeviceType.CUDA,
          ev.start_ns() / 1e3, ev.duration_ns() / 1e3)
         for ev in prof.profiler.kineto_results.events()),
        _SPAN_NAMES)


def summarize_events(events, spans_named) -> TraceSummary:
    """``events``: ``(name, on_device, start_us, duration_us)``;
    ``spans_named``: the benchmark's span names, which label idle
    gaps."""
    device, host = [], []
    host_names = set()
    for name, on_device, s, dur in events:
        if on_device:
            device.append((name, s, s + dur))
        else:
            host_names.add(name)
            host.append((name, s, s + dur))
    window = next(((s, e) for n, s, e in host if n == WINDOW), None)
    if window is None:
        raise RuntimeError("the profile holds no 'window' span")
    spans = [iv for iv in host
             if iv[0] in spans_named and iv[0] != WINDOW]
    ops = [iv for iv in device if iv[0] not in host_names]
    inside = [(n, max(s, window[0]), min(e, window[1]))
              for n, s, e in ops if e > window[0] and s < window[1]]
    return TraceSummary(inside, spans, window, busy(inside, *window))


_SPAN_NAMES = set()


def span(name: str):
    """A benchmark span around a call into the program."""
    _SPAN_NAMES.add(name)
    return torch.profiler.record_function(name)
