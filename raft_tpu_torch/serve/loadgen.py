"""Load generator for the serving runtime (counterpart of
``raft_tpu/serve/loadgen.py``).

Two standard modes, both against a live
:class:`~raft_tpu_torch.serve.Executor`:

closed loop
    N client threads, each submit → wait → submit. Offered load tracks
    service rate, so the measured queries/sec IS the saturation
    throughput for that concurrency; latency is the closed-loop response
    time.
open loop
    requests arrive on a fixed schedule (Poisson or uniform) regardless
    of completions, the arrival process real traffic has. Latency
    percentiles under open loop expose the queueing delay that closed
    loop hides (coordinated omission).

Both report p50/p99 latency, achieved queries/sec and rows/sec, the
executor's coalescing factor (real rows per device launch), and the
typed-error counts (rejections, deadline expiries). On top of them: the
fleet closed loop over a :class:`~raft_tpu_torch.serve.ReplicaGroup`
with a mid-run kill and its recovery-to-SLO clock, the five chaos
scenarios of :data:`CHAOS_SCENARIOS`, and the streaming-ingest and WAL
catch-up loops (duck-typed on their controller and follower).

Every query block is drawn by numpy's ``default_rng(seed + i)`` (client
``i``) or ``default_rng(seed)`` (the open loop's arrivals), as in the
reference, so one seed gives both packages the same request stream.
``python -m raft_tpu_torch.serve.loadgen`` runs it on ``cuda:0`` (see
:func:`main`).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from raft_tpu_torch.runtime import limits

__all__ = ["LoadReport", "FleetReport", "ChaosReport",
           "StreamingReport", "CatchupLoadReport", "closed_loop",
           "open_loop", "fleet_closed_loop", "streaming_loop",
           "catchup_under_load", "run_chaos", "CHAOS_SCENARIOS"]


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass
class LoadReport:
    """One load-generation run, summarized."""

    mode: str
    duration_s: float
    completed: int = 0
    rejected: int = 0                   # typed RejectedError
    deadline_failed: int = 0            # typed DeadlineExceededError
    rows: int = 0
    latencies_ms: List[float] = field(default_factory=list)
    coalescing_factor: float = 0.0
    batches: int = 0
    pad_overhead: float = 0.0           # padded rows / real rows
    select_k_bytes_per_s: float = 0.0   # radix-epilogue selection bandwidth
    slo: Dict[str, dict] = field(default_factory=dict)  # tenant -> SLO state
    obs_snapshot: Optional[Dict[str, object]] = None    # when metrics on
    # responses served per brownout level during the run ({} or {0: n}
    # means brownout never engaged)
    brownout_levels: Dict[int, int] = field(default_factory=dict)

    @property
    def qps(self) -> float:
        return self.completed / self.duration_s if self.duration_s else 0.0

    @property
    def rows_per_s(self) -> float:
        return self.rows / self.duration_s if self.duration_s else 0.0

    def percentile_ms(self, q: float) -> float:
        if not self.latencies_ms:
            return float("nan")
        return float(np.percentile(np.asarray(self.latencies_ms), q))

    @property
    def p50_ms(self) -> float:
        return self.percentile_ms(50.0)

    @property
    def p99_ms(self) -> float:
        return self.percentile_ms(99.0)

    def as_dict(self) -> Dict[str, object]:
        out = {
            "mode": self.mode,
            "duration_s": round(self.duration_s, 3),
            "completed": self.completed,
            "rejected": self.rejected,
            "deadline_failed": self.deadline_failed,
            "rows": self.rows,
            "qps": round(self.qps, 2),
            "rows_per_s": round(self.rows_per_s, 1),
            "p50_ms": round(self.p50_ms, 3),
            "p99_ms": round(self.p99_ms, 3),
            "coalescing_factor": round(self.coalescing_factor, 3),
            "batches": self.batches,
            "pad_overhead": round(self.pad_overhead, 4),
            "select_k_bytes_per_s": round(self.select_k_bytes_per_s, 1),
        }
        if self.brownout_levels:
            out["brownout_levels"] = {
                str(k): v for k, v in sorted(
                    self.brownout_levels.items())}
            out["brownout_max_level"] = max(self.brownout_levels)
        if self.slo:
            out["slo"] = self.slo
        if self.obs_snapshot is not None:
            # serving reports carry the counter families that explain
            # their latency numbers
            out["obs"] = self.obs_snapshot
        return out


def _snapshot(executor) -> tuple:
    s = executor.stats
    return (s.batches, s.rows, s.padded_rows,
            dict(s.brownout_levels))


def _finalize(report: LoadReport, executor, before: tuple,
              t0: float) -> LoadReport:
    report.duration_s = time.monotonic() - t0
    b0, r0, p0, *rest = before         # a 3-tuple is accepted too
    lv0 = rest[0] if rest else {}
    s = executor.stats
    db, dr, dp = s.batches - b0, s.rows - r0, s.padded_rows - p0
    report.batches = db
    report.coalescing_factor = dr / db if db else 0.0
    report.pad_overhead = dp / dr if dr else 0.0
    report.brownout_levels = {
        lvl: n - lv0.get(lvl, 0)
        for lvl, n in s.brownout_levels.items()
        if n - lv0.get(lvl, 0) > 0}
    # selection-stage bandwidth: the Executor._launch gauge for kNN
    # services on the radix epilogue (last-observed value per service;
    # the peak across services, 0.0 with metrics off)
    from raft_tpu_torch import obs

    fam = obs.snapshot()["metrics"].get("select_k_bytes_per_s")
    if fam and fam.get("series"):
        report.select_k_bytes_per_s = max(
            float(s["value"]) for s in fam["series"])
    # per-tenant SLO state (burn rate + window counts) from the
    # executor's QosPolicy, when one is wired and metering
    qos = getattr(executor, "qos", None)
    if qos is not None and hasattr(qos, "slo_snapshot"):
        report.slo = qos.slo_snapshot()
    if obs.enabled():
        report.obs_snapshot = obs.snapshot()
    return report


def _record(report: LoadReport, lock: threading.Lock, rows: int,
            t_submit: float, future, wait_s: float) -> None:
    """Wait one future out and fold the outcome into the report."""
    try:
        future.result(timeout=wait_s)
        ok, kind = True, None
    except limits.RejectedError:
        ok, kind = False, "rejected"
    except limits.DeadlineExceededError:
        ok, kind = False, "deadline"
    except TimeoutError:
        ok, kind = False, None
    lat_ms = (time.monotonic() - t_submit) * 1e3
    with lock:
        if ok:
            report.completed += 1
            report.rows += rows
            report.latencies_ms.append(lat_ms)
        elif kind == "rejected":
            report.rejected += 1
        elif kind == "deadline":
            report.deadline_failed += 1


def closed_loop(executor, op: str, *, clients: int = 8,
                rows: int = 4, duration_s: float = 2.0,
                tenants: Optional[Sequence[str]] = None,
                deadline_s: Optional[float] = None,
                seed: int = 0, wait_s: float = 30.0) -> LoadReport:
    """``clients`` threads in a submit→wait loop for ``duration_s``.
    Tenant ``i`` is ``tenants[i % len(tenants)]`` (default: one shared
    tenant), so a skewed tenant list doubles as a fairness workload."""
    svc = executor._service(op)
    tenants = list(tenants) if tenants else ["default"]
    report = LoadReport(mode="closed", duration_s=0.0)
    lock = threading.Lock()
    stop = threading.Event()
    before = _snapshot(executor)
    t0 = time.monotonic()

    def client(i: int) -> None:
        rng = np.random.default_rng(seed + i)
        tenant = tenants[i % len(tenants)]
        while not stop.is_set():
            q = rng.standard_normal((rows, svc.dim)).astype(svc.np_dtype)
            t_submit = time.monotonic()
            try:
                fut = executor.submit(op, q, tenant=tenant,
                                      deadline_s=deadline_s)
            except limits.RejectedError:
                with lock:
                    report.rejected += 1
                time.sleep(0.001)       # brief backoff, stay closed-loop
                continue
            _record(report, lock, rows, t_submit, fut, wait_s)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    for t in threads:
        t.start()
    time.sleep(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=wait_s)
    return _finalize(report, executor, before, t0)


@dataclass
class FleetReport:
    """One replica-fleet load run: per-replica rows plus the merged
    fleet row."""

    per_replica: Dict[str, LoadReport] = field(default_factory=dict)
    fleet: Optional[LoadReport] = None
    routed: int = 0                     # router counters for the run
    spills: int = 0
    router_rejected: int = 0
    hedges_issued: int = 0              # hedged second legs dispatched
    hedges_won: int = 0                 # hedge finished before primary
    hedge_rate: float = 0.0             # issued / routed
    killed: Optional[str] = None        # replica killed mid-run, if any
    kill_at_s: Optional[float] = None   # offset from run start
    # seconds from the kill to the first subsequent completion meeting
    # the tenant's SLO latency (any completion when no SLO is set);
    # None when nothing was killed, +inf when nothing recovered
    recovery_time_to_slo_s: Optional[float] = None

    def as_dict(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "mode": "fleet_closed",
            "replicas": {name: r.as_dict()
                         for name, r in self.per_replica.items()},
            "fleet": self.fleet.as_dict() if self.fleet else None,
            "routed": self.routed,
            "spills": self.spills,
            "router_rejected": self.router_rejected,
            "hedges_issued": self.hedges_issued,
            "hedges_won": self.hedges_won,
            "hedge_rate": round(self.hedge_rate, 4),
        }
        if self.killed is not None:
            out["killed"] = self.killed
            out["kill_at_s"] = round(self.kill_at_s, 3)
            out["recovery_time_to_slo_s"] = (
                round(self.recovery_time_to_slo_s, 4)
                if self.recovery_time_to_slo_s is not None else None)
        return out


def _slo_latency_s(group, tenant: str) -> Optional[float]:
    """The tenant's SLO latency from the first replica carrying a QoS
    policy (replicas share one policy table by construction)."""
    for r in group.replicas:
        qos = getattr(r.executor, "qos", None)
        if qos is not None:
            # a policy table without SLO fields means "no SLO configured"
            try:
                return qos.policy(tenant).slo_latency_s
            except (AttributeError, KeyError):
                return None
    return None


def fleet_closed_loop(group, op: str, *, clients: int = 8,
                      rows: int = 4, duration_s: float = 2.0,
                      tenants: Optional[Sequence[str]] = None,
                      deadline_s: Optional[float] = None,
                      seed: int = 0, wait_s: float = 30.0,
                      kill_after_s: Optional[float] = None,
                      kill=None) -> FleetReport:
    """Closed-loop load against a :class:`~raft_tpu_torch.serve.
    ReplicaGroup`.

    Routes every submit through the group's weighted-fair router and
    attributes each completion to the replica that served it, so the
    report carries one p50/p99/qps row per replica plus the merged fleet
    row. With ``kill_after_s`` set, a killer thread fires ``kill``
    (default: :meth:`ReplicaGroup.fail_replica` on the last healthy
    replica) mid-run and the report's ``recovery_time_to_slo_s`` is the
    time from the kill to the first subsequent completion meeting the
    tenant's SLO latency."""
    tenants = list(tenants) if tenants else ["default"]
    svc = None
    for r in group.healthy():
        try:
            svc = r.executor._service(op)
            break
        except (KeyError, ValueError):
            continue
    if svc is None:
        raise KeyError(f"no healthy replica serves op {op!r}")
    slo_s = _slo_latency_s(group, tenants[0])

    fleet = FleetReport()
    per_rep: Dict[str, LoadReport] = {
        r.name: LoadReport(mode="fleet_closed", duration_s=0.0)
        for r in group.replicas}
    merged = LoadReport(mode="fleet_closed", duration_s=0.0)
    lock = threading.Lock()
    stop = threading.Event()
    # (t_kill, recovery) shared with the record path
    kill_state: Dict[str, Optional[float]] = {"t_kill": None,
                                              "recovery": None}
    snaps = {r.name: (r, _snapshot(r.executor)) for r in group.replicas}
    routed0, spills0, rej0 = (group.stats.routed, group.stats.spills,
                              group.stats.rejected)
    hedged0, hwon0 = (group.stats.hedges_issued, group.stats.hedges_won)
    t0 = time.monotonic()

    def record(rep_name: str, t_submit: float, fut) -> None:
        try:
            fut.result(timeout=wait_s)
            ok, kind = True, None
        except limits.RejectedError:
            ok, kind = False, "rejected"
        except limits.DeadlineExceededError:
            ok, kind = False, "deadline"
        except TimeoutError:
            ok, kind = False, None
        t_done = time.monotonic()
        lat_ms = (t_done - t_submit) * 1e3
        with lock:
            reports = [merged]
            if rep_name in per_rep:
                reports.append(per_rep[rep_name])
            for rep in reports:
                if ok:
                    rep.completed += 1
                    rep.rows += rows
                    rep.latencies_ms.append(lat_ms)
                elif kind == "rejected":
                    rep.rejected += 1
                elif kind == "deadline":
                    rep.deadline_failed += 1
            t_kill = kill_state["t_kill"]
            if (ok and t_kill is not None
                    and kill_state["recovery"] is None
                    and t_submit >= t_kill
                    and (slo_s is None or lat_ms * 1e-3 <= slo_s)):
                kill_state["recovery"] = t_done - t_kill

    def client(i: int) -> None:
        rng = np.random.default_rng(seed + i)
        tenant = tenants[i % len(tenants)]
        while not stop.is_set():
            q = rng.standard_normal((rows, svc.dim)).astype(svc.np_dtype)
            t_submit = time.monotonic()
            try:
                replica, fut = group.route(op, q, tenant=tenant,
                                           deadline_s=deadline_s)
            except limits.RejectedError:
                with lock:
                    merged.rejected += 1
                time.sleep(0.001)
                continue
            record(replica.name, t_submit, fut)

    def killer() -> None:
        if stop.wait(kill_after_s):
            return                      # run ended before the kill
        live = group.healthy()
        if not live:
            return
        target = live[-1]
        with lock:
            fleet.killed = target.name
            kill_state["t_kill"] = time.monotonic()
            fleet.kill_at_s = kill_state["t_kill"] - t0
        if kill is not None:
            kill(target)
        else:
            group.fail_replica(target, "loadgen kill")

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    if kill_after_s is not None:
        threads.append(threading.Thread(target=killer, daemon=True))
    for t in threads:
        t.start()
    time.sleep(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=wait_s)

    for name, (replica, before) in snaps.items():
        _finalize(per_rep[name], replica.executor, before, t0)
    merged.duration_s = time.monotonic() - t0
    merged.batches = sum(r.batches for r in per_rep.values())
    tot_rows = sum(r.coalescing_factor * r.batches
                   for r in per_rep.values())
    merged.coalescing_factor = (tot_rows / merged.batches
                                if merged.batches else 0.0)
    merged.slo = (group.slo_snapshot()
                  if hasattr(group, "slo_snapshot") else {})
    fleet.per_replica = per_rep
    fleet.fleet = merged
    fleet.routed = group.stats.routed - routed0
    fleet.spills = group.stats.spills - spills0
    fleet.router_rejected = group.stats.rejected - rej0
    fleet.hedges_issued = group.stats.hedges_issued - hedged0
    fleet.hedges_won = group.stats.hedges_won - hwon0
    fleet.hedge_rate = (fleet.hedges_issued / fleet.routed
                        if fleet.routed else 0.0)
    if fleet.killed is not None:
        fleet.recovery_time_to_slo_s = (
            kill_state["recovery"] if kill_state["recovery"] is not None
            else float("inf"))
    return fleet


def open_loop(executor, op: str, *, rate_qps: float = 200.0,
              rows: int = 4, duration_s: float = 2.0,
              tenants: Optional[Sequence[str]] = None,
              deadline_s: Optional[float] = None,
              poisson: bool = True, seed: int = 0,
              wait_s: float = 30.0) -> LoadReport:
    """Submit on a fixed arrival schedule (Poisson by default) without
    waiting for completions: each in-flight request is awaited by a
    collector thread, so measured latency includes queueing delay (no
    coordinated omission)."""
    svc = executor._service(op)
    tenants = list(tenants) if tenants else ["default"]
    rng = np.random.default_rng(seed)
    report = LoadReport(mode="open", duration_s=0.0)
    lock = threading.Lock()
    collectors: List[threading.Thread] = []
    before = _snapshot(executor)
    t0 = time.monotonic()
    end = t0 + duration_s
    next_at = t0
    i = 0
    while True:
        now = time.monotonic()
        if now >= end:
            break
        if now < next_at:
            time.sleep(min(next_at - now, 0.005))
            continue
        gap = (rng.exponential(1.0 / rate_qps) if poisson
               else 1.0 / rate_qps)
        next_at += gap
        q = rng.standard_normal((rows, svc.dim)).astype(svc.np_dtype)
        tenant = tenants[i % len(tenants)]
        i += 1
        t_submit = time.monotonic()
        try:
            fut = executor.submit(op, q, tenant=tenant,
                                  deadline_s=deadline_s)
        except limits.RejectedError:
            with lock:
                report.rejected += 1
            continue
        c = threading.Thread(
            target=_record,
            args=(report, lock, rows, t_submit, fut, wait_s),
            daemon=True)
        c.start()
        collectors.append(c)
    for c in collectors:
        c.join(timeout=wait_s)
    return _finalize(report, executor, before, t0)


# ---------------------------------------------------------------------------
# traffic-chaos scenarios
# ---------------------------------------------------------------------------

@dataclass
class ChaosReport:
    """One chaos scenario run: named phases (each a LoadReport or
    FleetReport dict) plus the resilience witnesses the checks assert on,
    as typed fields."""

    scenario: str
    phases: Dict[str, Dict[str, object]] = field(default_factory=dict)
    brownout_max_level: int = 0         # deepest level actually served
    brownout_recovered: bool = True     # level back to 0 at scenario end
    retraces_during: int = 0            # compiles after the warm phase
    rejected_total: int = 0             # typed rejections, all phases
    hedges_issued: int = 0
    hedges_won: int = 0
    hedge_rate: float = 0.0
    notes: Dict[str, object] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "scenario": self.scenario,
            "phases": self.phases,
            "brownout_max_level": self.brownout_max_level,
            "brownout_recovered": self.brownout_recovered,
            "retraces_during": self.retraces_during,
            "rejected_total": self.rejected_total,
            "hedges_issued": self.hedges_issued,
            "hedges_won": self.hedges_won,
            "hedge_rate": round(self.hedge_rate, 4),
        }
        if self.notes:
            out["notes"] = self.notes
        return out


def _group_closed_loop(group, op: str, *, clients: int = 8,
                       rows: int = 4, duration_s: float = 2.0,
                       tenants: Optional[Sequence[str]] = None,
                       deadline_s: Optional[float] = None,
                       seed: int = 0, wait_s: float = 30.0
                       ) -> LoadReport:
    """Closed loop through :meth:`ReplicaGroup.submit`, the HEDGED fleet
    entry point (:func:`fleet_closed_loop` routes unhedged for
    per-replica attribution; this measures what a hedging client
    sees)."""
    tenants = list(tenants) if tenants else ["default"]
    report = LoadReport(mode="group_closed", duration_s=0.0)
    lock = threading.Lock()
    stop = threading.Event()
    dim = None
    dtype = None
    for r in group.healthy():
        try:
            svc = r.executor._service(op)
            dim, dtype = svc.dim, svc.np_dtype
            break
        except (KeyError, ValueError):
            continue
    if dim is None:
        raise KeyError(f"no healthy replica serves op {op!r}")
    t0 = time.monotonic()

    def client(i: int) -> None:
        rng = np.random.default_rng(seed + i)
        tenant = tenants[i % len(tenants)]
        while not stop.is_set():
            q = rng.standard_normal((rows, dim)).astype(dtype)
            t_submit = time.monotonic()
            try:
                fut = group.submit(op, q, tenant=tenant,
                                   deadline_s=deadline_s)
            except limits.RejectedError:
                with lock:
                    report.rejected += 1
                time.sleep(0.001)
                continue
            _record(report, lock, rows, t_submit, fut, wait_s)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    for t in threads:
        t.start()
    time.sleep(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=wait_s)
    report.duration_s = time.monotonic() - t0
    return report


def chaos_traffic_step(executor, op: str, *, base_qps: float = 50.0,
                       step_factor: float = 4.0, rows: int = 4,
                       phase_s: float = 2.0,
                       recovery_s: Optional[float] = None,
                       tenants: Optional[Sequence[str]] = None,
                       deadline_s: Optional[float] = None,
                       seed: int = 0) -> ChaosReport:
    """Open-loop traffic step: ``base_qps`` → ``step_factor`` × → back.

    The witnesses: the brownout controller engages during the step
    (level > 0 responses served), every transition runs warmed programs
    (``retraces_during`` stays 0), and the level returns to 0 in the
    recovery phase."""
    rep = ChaosReport(scenario="traffic_step")
    traces0 = executor.stats.traces
    common = dict(rows=rows, tenants=tenants, deadline_s=deadline_s,
                  seed=seed)
    phases = (("base", base_qps, phase_s),
              ("step", base_qps * step_factor, phase_s),
              ("recovery", base_qps,
               phase_s if recovery_s is None else recovery_s))
    for name, qps, dur in phases:
        r = open_loop(executor, op, rate_qps=qps, duration_s=dur,
                      **common)
        rep.phases[name] = r.as_dict()
        rep.rejected_total += r.rejected
        if r.brownout_levels:
            rep.brownout_max_level = max(rep.brownout_max_level,
                                         max(r.brownout_levels))
    rep.retraces_during = executor.stats.traces - traces0
    ctl = getattr(executor, "brownout", None)
    rep.brownout_recovered = ctl is None or not ctl.snapshot()
    if ctl is not None:
        rep.notes["controller"] = ctl.snapshot()
    return rep


def chaos_slow_replica(group, op: str, *, stall_s: float = 0.05,
                       victim: int = 0, clients: int = 8,
                       rows: int = 4, phase_s: float = 2.0,
                       stall_duty: float = 1.0,
                       stall_period_s: float = 0.5,
                       tenants: Optional[Sequence[str]] = None,
                       deadline_s: Optional[float] = None,
                       seed: int = 0) -> ChaosReport:
    """One replica straggles (``FaultInjector.stall`` on its executor,
    a host sleep before each of its launches); hedged dispatch should
    hold fleet p99 near the healthy baseline while spending at most the
    hedge budget. Phases: ``healthy`` (baseline), ``stalled`` (victim
    straggling), ``healed`` (stall disarmed).

    ``stall_duty`` < 1 makes the straggler INTERMITTENT: the stall is
    armed for ``stall_duty x stall_period_s`` of every period and
    disarmed for the rest (the GC-pause or compaction profile hedging is
    built for). A constant straggler (duty 1.0, the default) slows half
    a 2-replica fleet's traffic, more demand than a 5% hedge budget can
    cover by design; the duty-cycled profile keeps the latency spikes in
    the tail where the budget reaches them."""
    if not 0.0 < stall_duty <= 1.0:
        raise ValueError(f"stall_duty must be in (0, 1], "
                         f"got {stall_duty}")
    if not stall_period_s > 0.0:
        raise ValueError(f"stall_period_s must be > 0, "
                         f"got {stall_period_s}")
    inj = group.replicas[victim].executor.faults
    if inj is None:
        raise ValueError(
            f"replica {victim} has no FaultInjector attached: build "
            f"its Executor with faults=FaultInjector(...) to run the "
            f"slow-replica scenario")
    rep = ChaosReport(scenario="slow_replica")
    issued0, won0 = (group.stats.hedges_issued, group.stats.hedges_won)
    routed0 = group.stats.routed
    common = dict(clients=clients, rows=rows, duration_s=phase_s,
                  tenants=tenants, deadline_s=deadline_s, seed=seed)
    r = _group_closed_loop(group, op, **common)
    rep.phases["healthy"] = r.as_dict()
    rep.rejected_total += r.rejected
    toggler: Optional[threading.Thread] = None
    stop_toggle = threading.Event()
    if stall_duty < 1.0:
        def _toggle() -> None:
            while True:
                inj.stall(stall_s)
                if stop_toggle.wait(stall_period_s * stall_duty):
                    return
                inj.stall(0.0)
                if stop_toggle.wait(stall_period_s
                                    * (1.0 - stall_duty)):
                    return

        toggler = threading.Thread(target=_toggle, daemon=True,
                                   name="raft-tpu-stall-toggle")
        toggler.start()
    else:
        inj.stall(stall_s)
    try:
        r = _group_closed_loop(group, op, **common)
        rep.phases["stalled"] = r.as_dict()
        rep.rejected_total += r.rejected
    finally:
        stop_toggle.set()
        if toggler is not None:
            toggler.join(timeout=10.0)
        inj.stall(0.0)
    r = _group_closed_loop(group, op, **common)
    rep.phases["healed"] = r.as_dict()
    rep.rejected_total += r.rejected
    rep.hedges_issued = group.stats.hedges_issued - issued0
    rep.hedges_won = group.stats.hedges_won - won0
    routed = group.stats.routed - routed0
    rep.hedge_rate = rep.hedges_issued / routed if routed else 0.0
    rep.notes["victim"] = group.replicas[victim].name
    rep.notes["stall_s"] = stall_s
    if stall_duty < 1.0:
        rep.notes["stall_duty"] = stall_duty
        rep.notes["stall_period_s"] = stall_period_s
    return rep


def chaos_hog_tenant(executor, op: str, *, hog_clients: int = 6,
                     light_clients: int = 2, rows: int = 4,
                     phase_s: float = 2.0,
                     deadline_s: Optional[float] = None,
                     seed: int = 0) -> ChaosReport:
    """One tenant floods the queue while a light tenant keeps its small
    trickle: weighted-fair scheduling plus per-tenant brownout should
    degrade the HOG (its burn rate spikes first) while the light tenant,
    typically pinned by ``min_quality``, keeps full quality."""
    rep = ChaosReport(scenario="hog_tenant")
    tenants = ["hog"] * hog_clients + ["light"] * light_clients
    r = closed_loop(executor, op, clients=hog_clients + light_clients,
                    rows=rows, duration_s=phase_s, tenants=tenants,
                    deadline_s=deadline_s, seed=seed)
    rep.phases["flood"] = r.as_dict()
    rep.rejected_total = r.rejected
    if r.brownout_levels:
        rep.brownout_max_level = max(r.brownout_levels)
    ctl = getattr(executor, "brownout", None)
    if ctl is not None:
        snap = ctl.snapshot()
        rep.notes["controller"] = snap
        rep.notes["light_level"] = max(
            (lv.get("light", 0) for lv in snap.values()), default=0)
        rep.brownout_recovered = not snap
    return rep


def chaos_kill_mid_spike(group, op: str, *, clients: int = 8,
                         rows: int = 4, phase_s: float = 2.0,
                         kill_after_s: Optional[float] = None,
                         tenants: Optional[Sequence[str]] = None,
                         deadline_s: Optional[float] = None,
                         seed: int = 0) -> ChaosReport:
    """A replica dies at the peak of a closed-loop spike: heal-path
    routing, brownout and hedging all under one roof. Wraps
    :func:`fleet_closed_loop`'s kill machinery and surfaces its
    recovery-to-SLO clock."""
    rep = ChaosReport(scenario="kill_mid_spike")
    fr = fleet_closed_loop(
        group, op, clients=clients, rows=rows, duration_s=phase_s,
        tenants=tenants, deadline_s=deadline_s, seed=seed,
        kill_after_s=kill_after_s
        if kill_after_s is not None else phase_s / 3)
    rep.phases["spike"] = fr.as_dict()
    rep.rejected_total = (fr.fleet.rejected if fr.fleet else 0) \
        + fr.router_rejected
    rep.hedges_issued = fr.hedges_issued
    rep.hedges_won = fr.hedges_won
    rep.hedge_rate = fr.hedge_rate
    levels = (fr.fleet.brownout_levels if fr.fleet else {}) or {}
    for rrep in fr.per_replica.values():
        for lvl, n in rrep.brownout_levels.items():
            levels[lvl] = levels.get(lvl, 0) + n
    if levels:
        rep.brownout_max_level = max(levels)
    rep.notes["killed"] = fr.killed
    rep.notes["recovery_time_to_slo_s"] = fr.recovery_time_to_slo_s
    return rep


def chaos_kill_leader(group, op: str, *, clients: int = 8,
                      rows: int = 4, phase_s: float = 2.0,
                      kill_after_s: Optional[float] = None,
                      promote=None,
                      tenants: Optional[Sequence[str]] = None,
                      deadline_s: Optional[float] = None,
                      seed: int = 0) -> ChaosReport:
    """The fleet's WRITE leader dies at the peak of a closed-loop spike
    (the serving half of a leader election): queries keep routing across
    the survivors throughout, and a survivor is promoted via
    :meth:`ReplicaGroup.promote`; the leader MARKER moves, no data does,
    so the promotion itself compiles nothing.

    ``promote`` picks the successor from the group (default: the first
    healthy survivor; a real fleet passes the election winner's replica
    here). Stamps both failover clocks: ``time_to_new_leader_s`` (kill to
    promote-returned) and ``recovery_time_to_slo_s`` (kill to the first
    subsequent completion meeting the tenant SLO)."""
    rep = ChaosReport(scenario="kill_leader")
    # make the write leader the replica the kill machinery targets
    leader = group.promote(group.healthy()[-1].name)
    state: Dict[str, float] = {}

    def kill_leader(target) -> None:
        t_kill = time.monotonic()
        group.fail_replica(target, "leader killed")
        pick = promote(group) if promote is not None \
            else group.healthy()[0]
        group.promote(getattr(pick, "name", pick))
        state["time_to_new_leader_s"] = time.monotonic() - t_kill

    fr = fleet_closed_loop(
        group, op, clients=clients, rows=rows, duration_s=phase_s,
        tenants=tenants, deadline_s=deadline_s, seed=seed,
        kill_after_s=kill_after_s
        if kill_after_s is not None else phase_s / 3,
        kill=kill_leader)
    rep.phases["spike"] = fr.as_dict()
    rep.rejected_total = (fr.fleet.rejected if fr.fleet else 0) \
        + fr.router_rejected
    rep.hedges_issued = fr.hedges_issued
    rep.hedges_won = fr.hedges_won
    rep.hedge_rate = fr.hedge_rate
    rep.notes["killed_leader"] = fr.killed
    rep.notes["old_leader"] = leader.name
    new = group.leader
    rep.notes["new_leader"] = None if new is None else new.name
    rep.notes["time_to_new_leader_s"] = state.get(
        "time_to_new_leader_s")
    rep.notes["recovery_time_to_slo_s"] = fr.recovery_time_to_slo_s
    return rep


@dataclass
class StreamingReport:
    """One streaming-ingest load run: sustained inserts + deletes racing
    concurrent queries, with per-query recall measured against an exact
    reference over the snapshot the query targeted. ``min_recall``
    across the run is the swap-safety witness: it covers every query
    served while a compaction swap was in flight."""

    duration_s: float
    queries: int = 0
    failed: int = 0
    ingest_rows: int = 0
    deleted_rows: int = 0
    ingest_batches: int = 0
    latencies_ms: List[float] = field(default_factory=list)
    recalls: List[float] = field(default_factory=list)
    swaps: int = 0                      # epoch-bumped (shape) swaps
    refreshes: int = 0                  # all serving-snapshot publishes
    compactions: int = 0                # background compaction cycles
    n_live_final: int = 0

    @property
    def qps(self) -> float:
        return self.queries / self.duration_s if self.duration_s else 0.0

    @property
    def ingest_rate(self) -> float:
        """Inserted rows per second, sustained across the run."""
        return (self.ingest_rows / self.duration_s
                if self.duration_s else 0.0)

    def percentile_ms(self, q: float) -> float:
        if not self.latencies_ms:
            return float("nan")
        return float(np.percentile(np.asarray(self.latencies_ms), q))

    @property
    def p50_ms(self) -> float:
        return self.percentile_ms(50.0)

    @property
    def p99_ms(self) -> float:
        return self.percentile_ms(99.0)

    @property
    def min_recall(self) -> float:
        return min(self.recalls) if self.recalls else float("nan")

    @property
    def mean_recall(self) -> float:
        return (float(np.mean(self.recalls)) if self.recalls
                else float("nan"))

    def as_dict(self) -> Dict[str, object]:
        return {
            "mode": "streaming",
            "duration_s": round(self.duration_s, 3),
            "queries": self.queries,
            "failed": self.failed,
            "qps": round(self.qps, 2),
            "ingest_rows": self.ingest_rows,
            "deleted_rows": self.deleted_rows,
            "ingest_batches": self.ingest_batches,
            "ingest_rate": round(self.ingest_rate, 1),
            "p50_ms": round(self.p50_ms, 3),
            "p99_ms": round(self.p99_ms, 3),
            "min_recall": round(self.min_recall, 4),
            "mean_recall": round(self.mean_recall, 4),
            "swaps": self.swaps,
            "refreshes": self.refreshes,
            "compactions": self.compactions,
            "n_live_final": self.n_live_final,
        }


def _snapshot_exact_ids(snap, q: np.ndarray, k: int) -> np.ndarray:
    """Exact top-k external ids over one streaming snapshot's live rows,
    the reference each query's recall is scored against. It runs on the
    snapshot's device (on the card the host copy of a full-size database
    would cost each query far more than its search): distances in f32 as
    the reference's numpy formula writes them, a stable sort over the
    rows in id order, the ids back on the host."""
    from raft_tpu_torch.neighbors.streaming import _live_of

    flat = snap.flat
    rows, ids = _live_of(flat, snap.tomb_words)
    rows = rows.to(torch.float32)
    qt = torch.as_tensor(np.asarray(q, np.float32), device=rows.device)
    if flat.metric == "ip":
        d = -(qt @ rows.T)
    else:
        d = ((qt * qt).sum(1)[:, None] - 2.0 * (qt @ rows.T)
             + (rows * rows).sum(1)[None, :])
    top = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return _host(ids[top])


def streaming_loop(controller, op: str, *, clients: int = 4,
                   rows: int = 4, duration_s: float = 2.0,
                   ingest_rows: int = 32,
                   ingest_interval_s: float = 0.05,
                   delete_frac: float = 0.3, seed: int = 0,
                   wait_s: float = 30.0) -> StreamingReport:
    """Sustained ingest racing concurrent queries against one streaming
    ingest controller (duck-typed: ``executor``, ``insert``, ``delete``,
    ``submit``, ``stream``, ``swaps``, ``refreshes``,
    ``compactor.compactions``).

    One ingester thread inserts ``ingest_rows`` rows every
    ``ingest_interval_s`` and tombstones ``delete_frac`` of each batch
    (feeding the background compactor); ``clients`` query threads run
    the closed loop against ``op``, each scoring its response against an
    exact reference computed over the snapshot it targeted, so a torn or
    stale swap shows up as a recall dip, not a silent wrong answer.
    Recall is relative to exact search over the live rows, so a floor
    must budget for the op's nprobe (``nprobe = n_lists - 1`` is a
    near-exact probe that still rides the masked partial path)."""
    svc = controller.executor._service(op)
    k = svc.k
    report = StreamingReport(duration_s=0.0)
    lock = threading.Lock()
    stop = threading.Event()
    swaps0 = controller.swaps
    refreshes0 = controller.refreshes
    compactions0 = controller.compactor.compactions

    def ingester() -> None:
        rng = np.random.default_rng(seed + 10_000)
        while not stop.is_set():
            batch = rng.standard_normal(
                (ingest_rows, svc.dim)).astype(svc.np_dtype)
            ids = controller.insert(batch)
            n_del = int(round(len(ids) * delete_frac))
            if n_del:
                controller.delete(ids[:n_del])
            with lock:
                report.ingest_rows += len(ids)
                report.ingest_batches += 1
                report.deleted_rows += n_del
            if stop.wait(ingest_interval_s):
                return

    def _recall(got: np.ndarray, ref: np.ndarray) -> float:
        return float(np.mean(
            [len(set(got[j].tolist()) & set(ref[j].tolist())) / k
             for j in range(got.shape[0])]))

    def client(i: int) -> None:
        rng = np.random.default_rng(seed + i)
        while not stop.is_set():
            q = rng.standard_normal((rows, svc.dim)).astype(svc.np_dtype)
            before = svc.stream.snapshot
            t_submit = time.monotonic()
            try:
                fut = controller.submit(op, q)
                d, got = fut.result(timeout=wait_s)
            except Exception:  # noqa: BLE001 — tallied, loop continues
                with lock:
                    report.failed += 1
                continue
            lat_ms = (time.monotonic() - t_submit) * 1e3
            got = _host(got)
            # a query in flight across swaps may serve ANY consistent
            # version from its submit→complete window: score against
            # each and keep the best. A torn swap matches NO version and
            # still craters the recall.
            rec = _recall(got, _snapshot_exact_ids(before, q, k))
            if rec < 1.0:
                for snap in svc.stream.recent_snapshots():
                    if snap.version <= before.version or rec >= 1.0:
                        continue
                    rec = max(rec, _recall(
                        got, _snapshot_exact_ids(snap, q, k)))
            with lock:
                report.queries += 1
                report.latencies_ms.append(lat_ms)
                report.recalls.append(rec)

    threads = [threading.Thread(target=ingester, daemon=True)]
    threads += [threading.Thread(target=client, args=(i,), daemon=True)
                for i in range(clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    time.sleep(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=wait_s)
    report.duration_s = time.monotonic() - t0
    report.swaps = controller.swaps - swaps0
    report.refreshes = controller.refreshes - refreshes0
    report.compactions = controller.compactor.compactions - compactions0
    report.n_live_final = controller.stream.n_live
    return report


@dataclass
class CatchupLoadReport:
    """One WAL catch-up run under query load: a follower replays the
    leader's shipped records while queries race the mirror-applies, each
    scored against an exact reference over the snapshot it targeted.
    ``min_recall`` is the recall floor during catch-up; ``skipped``
    counts queries deferred while the follower held fewer than ``k`` live
    rows (a snapshot-bootstrapped follower starts empty)."""

    duration_s: float
    queries: int = 0
    skipped: int = 0
    latencies_ms: List[float] = field(default_factory=list)
    recalls: List[float] = field(default_factory=list)
    applied_seq: int = -1
    target_seq: int = -1
    resyncs: int = 0
    catchup_seconds: float = float("nan")

    @property
    def min_recall(self) -> float:
        return min(self.recalls) if self.recalls else float("nan")

    @property
    def mean_recall(self) -> float:
        return (float(np.mean(self.recalls)) if self.recalls
                else float("nan"))

    def percentile_ms(self, q: float) -> float:
        if not self.latencies_ms:
            return float("nan")
        return float(np.percentile(np.asarray(self.latencies_ms), q))

    def as_dict(self) -> Dict[str, object]:
        return {
            "mode": "catchup",
            "duration_s": round(self.duration_s, 3),
            "queries": self.queries,
            "skipped": self.skipped,
            "p50_ms": round(self.percentile_ms(50.0), 3),
            "p99_ms": round(self.percentile_ms(99.0), 3),
            "min_recall": round(self.min_recall, 4),
            "mean_recall": round(self.mean_recall, 4),
            "applied_seq": self.applied_seq,
            "target_seq": self.target_seq,
            "resyncs": self.resyncs,
            "catchup_seconds": round(self.catchup_seconds, 3),
        }


def catchup_under_load(follower, *, k: int, nprobe: int,
                       target_seq: int, rows: int = 4, seed: int = 0,
                       wait_s: float = 30.0) -> CatchupLoadReport:
    """Drive one WAL follower (duck-typed: ``index``, ``catch_up``,
    ``drain``, ``applied_seq``, ``resyncs``) through a full catch-up
    (snapshot resync if gapped, then record drain to ``target_seq``)
    while querying it the whole time.

    A worker thread runs ``follower.catch_up()`` then drains shipped
    records until ``follower.applied_seq >= target_seq``; the foreground
    loop searches the follower's index directly, scoring per-query
    recall against the exact reference over the snapshot the query
    targeted (best-of over ``recent_snapshots()`` when a mirror-apply
    published mid-flight, the :func:`streaming_loop` discipline).
    Queries are counted as ``skipped`` while the follower holds fewer
    than ``k`` live rows. The report's ``min_recall`` covers every query
    answered during catch-up."""
    index = follower.index
    report = CatchupLoadReport(duration_s=0.0, target_seq=target_seq)
    done = threading.Event()
    errors: List[BaseException] = []
    t0 = time.monotonic()

    def worker() -> None:
        try:
            cr = follower.catch_up(timeout=wait_s)
            report.catchup_seconds = cr.seconds
            while follower.applied_seq < target_seq:
                if follower.drain() == 0:
                    if time.monotonic() - t0 > wait_s:
                        raise TimeoutError(
                            f"follower stalled at seq "
                            f"{follower.applied_seq} < {target_seq}")
                    time.sleep(0.001)
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)
        finally:
            done.set()

    def _recall(got: np.ndarray, ref: np.ndarray) -> float:
        return float(np.mean(
            [len(set(got[j].tolist()) & set(ref[j].tolist())) / k
             for j in range(got.shape[0])]))

    rng = np.random.default_rng(seed)
    # warm the search BEFORE racing it against the apply stream: the
    # first call's build can outlast the snapshot ring (applies keep
    # publishing), which would make its result unscorable
    warm_snap = index.snapshot
    if warm_snap.n_live >= k:
        index.search(rng.standard_normal(
            (rows, warm_snap.flat.dim)).astype(np.float32), k, nprobe)
    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        if errors:
            break
        snap = index.snapshot
        if snap.n_live < k:
            if done.is_set():
                # catch-up finished: re-read once (the snapshot install
                # may have landed after the first read) and give up only
                # if the follower truly never grew to k
                snap = index.snapshot
                if snap.n_live < k:
                    break
            else:
                report.skipped += 1
                time.sleep(0.001)
                continue
        q = rng.standard_normal(
            (rows, snap.flat.dim)).astype(np.float32)
        t_q = time.monotonic()
        _, got = index.search(q, k, nprobe)
        lat_ms = (time.monotonic() - t_q) * 1e3
        # take the candidate versions NOW, before the (slow) exact
        # scoring: applies keep publishing and would walk the bounded
        # ring past the version the search actually served
        cands = [snap] + [s for s in index.recent_snapshots()
                          if s.version > snap.version]
        got = _host(got)
        rec = 0.0
        # a mirror-apply published mid-flight: any consistent version
        # from the query window is legitimate
        for s in cands:
            rec = max(rec, _recall(got, _snapshot_exact_ids(s, q, k)))
            if rec >= 1.0:
                break
        report.queries += 1
        report.latencies_ms.append(lat_ms)
        report.recalls.append(rec)
        if done.is_set():
            break  # at least one query answered post-catch-up
    t.join(timeout=wait_s)
    if errors:
        raise errors[0]
    report.duration_s = time.monotonic() - t0
    report.applied_seq = follower.applied_seq
    report.resyncs = follower.resyncs
    return report


#: scenario name -> callable(target, op, **kwargs). ``traffic_step`` and
#: ``hog_tenant`` take an Executor; the fleet scenarios take a
#: ReplicaGroup.
CHAOS_SCENARIOS = {
    "traffic_step": chaos_traffic_step,
    "slow_replica": chaos_slow_replica,
    "hog_tenant": chaos_hog_tenant,
    "kill_mid_spike": chaos_kill_mid_spike,
    "kill_leader": chaos_kill_leader,
}


def run_chaos(scenario: str, target, op: str, **kwargs) -> ChaosReport:
    """Dispatch one named chaos scenario against an Executor or
    ReplicaGroup (see :data:`CHAOS_SCENARIOS`)."""
    fn = CHAOS_SCENARIOS.get(scenario)
    if fn is None:
        raise ValueError(f"unknown chaos scenario {scenario!r}; have "
                         f"{sorted(CHAOS_SCENARIOS)}")
    return fn(target, op, **kwargs)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m raft_tpu_torch.serve.loadgen``: run the generator
    against a synthetic kNN fleet and print the report as JSON.

    ``--replicas N`` starts N warmed replicas behind a
    :class:`~raft_tpu_torch.serve.ReplicaGroup` and runs the fleet closed
    loop (per-replica rows + merged row); ``--kill-after S`` kills one
    replica mid-run and reports ``recovery_time_to_slo_s``. The database
    and every launch are on ``--device``, ``cuda:0`` by default; without
    CUDA that raises unless ``--device cpu`` is given."""
    import argparse
    import json

    p = argparse.ArgumentParser(prog="raft_tpu_torch.serve.loadgen")
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--rows", type=int, default=4)
    p.add_argument("--duration", type=float, default=2.0)
    p.add_argument("--mode", choices=("closed", "open"),
                   default="closed")
    p.add_argument("--rate-qps", type=float, default=200.0)
    p.add_argument("--n-db", type=int, default=4096)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--metric", default="l2")
    p.add_argument("--deadline", type=float, default=None)
    p.add_argument("--slo-ms", type=float, default=None,
                   help="default-tenant SLO latency (arms burn-rate "
                        "metering and the recovery-to-SLO clock)")
    p.add_argument("--kill-after", type=float, default=None,
                   help="kill one replica this many seconds into the "
                        "run (needs --replicas >= 2)")
    p.add_argument("--chaos", choices=sorted(CHAOS_SCENARIOS),
                   default=None,
                   help="run one chaos scenario instead of a plain "
                        "load run (arms brownout + hedging)")
    p.add_argument("--stall", type=float, default=0.05,
                   help="slow-replica scenario stall seconds")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda:0",
                   help="where the database lives and the launches run "
                        "(cuda:0 by default; cpu runs the kernels' "
                        "plain versions)")
    args = p.parse_args(argv)
    if args.kill_after is not None and args.replicas < 2:
        p.error("--kill-after needs --replicas >= 2")

    import torch

    from raft_tpu_torch.core.resources import resolve_device
    from raft_tpu_torch.serve import (BatchPolicy, BrownoutController,
                                      Executor, HedgePolicy, KnnService,
                                      QosPolicy, ReplicaGroup,
                                      TenantPolicy, knn_ladder)
    from raft_tpu_torch.serve.queue import bucket_ladder

    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    db = torch.as_tensor(
        rng.standard_normal((args.n_db, args.dim)).astype(np.float32),
        device=device)
    op = f"knn_k{args.k}_{args.metric}"

    def make_executor(*, with_brownout: bool = False, faults=None):
        qos = None
        if args.slo_ms is not None:
            qos = QosPolicy({"default": TenantPolicy(
                slo_latency_s=args.slo_ms * 1e-3)})
        brown = None
        if with_brownout:
            ks = sorted({args.k, max(args.k // 2, 1),
                         max(args.k // 4, 1)}, reverse=True)
            brown = BrownoutController(
                [knn_ladder(db, ks, metric=args.metric)], qos=qos)
        ex = Executor([KnnService(db, k=args.k, metric=args.metric)],
                      policy=BatchPolicy(max_batch=256, max_wait_ms=2.0),
                      qos=qos, brownout=brown, faults=faults)
        ex.warm(bucket_ladder(256))
        return ex

    common = dict(clients=args.clients, rows=args.rows,
                  duration_s=args.duration, deadline_s=args.deadline,
                  seed=args.seed)
    if args.chaos is not None:
        from raft_tpu_torch.comms.faults import FaultInjector

        kw = dict(rows=args.rows, phase_s=args.duration,
                  deadline_s=args.deadline, seed=args.seed)
        if args.chaos in ("traffic_step", "hog_tenant"):
            if args.chaos == "traffic_step":
                kw["base_qps"] = args.rate_qps
            ex = make_executor(with_brownout=True)
            with ex:
                report = run_chaos(args.chaos, ex, op, **kw)
        else:
            n = max(args.replicas, 2)
            group = ReplicaGroup(
                [make_executor(faults=FaultInjector(seed=args.seed))
                 for _ in range(n)],
                hedge=HedgePolicy())
            kw["clients"] = args.clients
            if args.chaos == "slow_replica":
                kw["stall_s"] = args.stall
            with group:
                report = run_chaos(args.chaos, group, op, **kw)
        print(json.dumps(report.as_dict(), indent=2, sort_keys=True))
        return 0
    if args.replicas > 1:
        group = ReplicaGroup([make_executor()
                              for _ in range(args.replicas)])
        with group:
            report = fleet_closed_loop(group, op,
                                       kill_after_s=args.kill_after,
                                       **common)
    else:
        ex = make_executor()
        with ex:
            if args.mode == "open":
                common.pop("clients")
                report = open_loop(ex, op, rate_qps=args.rate_qps,
                                   **common)
            else:
                report = closed_loop(ex, op, **common)
    print(json.dumps(report.as_dict(), indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
