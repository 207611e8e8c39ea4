"""Streaming ingest on the serving path (counterpart of
``raft_tpu/serve/ingest.py``): an IVF-Flat serve op whose fixed operands
follow a :class:`~raft_tpu_torch.neighbors.streaming.StreamingIndex`
through mutation, background compaction and drift refits, with no
compile on the query path.

A compaction or refit swaps the index's packed tensors and may change
their shapes, which an exported program fixes. Two mechanisms keep the
query path clear:

- **epoch-consistent launches** (``serve/executor.py``): a service holds
  ``(epoch, fixed_args, statics)`` as one tuple; a dispatch reads it
  once and uses it for the executable lookup (keyed by the epoch) and
  the call, so a swap never pairs new shapes with an old executable.
  A query racing a swap serves the old snapshot, whose tensors no
  mutation writes.
- **pre-warm, then publish** (:class:`IngestController`): when a swap
  changes shapes, the new epoch's executables are built and run once
  for the whole bucket ladder while queries keep the old epoch, and only
  then is the new tuple published. A same-shape swap (a delete, a
  fitting insert) publishes at once: the warmed programs stay valid.

Every thread here (the ingest caller, the compactor's worker, the
executor's drain thread) issues its device work on the device's default
stream, so a published snapshot's writes are ordered before any launch
that reads it.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from raft_tpu_torch import obs
from raft_tpu_torch.neighbors.streaming import Compactor, StreamingIndex
from raft_tpu_torch.runtime import limits
from raft_tpu_torch.serve.executor import Executor, Service
from raft_tpu_torch.serve.queue import bucket_ladder

__all__ = ["StreamingKnnService", "IngestController", "NotLeaderError"]


class NotLeaderError(RuntimeError):
    """A mutation reached a controller whose replica is not the leader.
    ``leader`` is the rank to send the write to again, with the same
    ``write_id`` (the dedup map makes the retry idempotent)."""

    def __init__(self, *, leader: int, rank: Optional[int] = None):
        where = f"replica rank {rank}" if rank is not None else \
            "a follower replica"
        super().__init__(
            f"not the leader: {where} cannot accept writes; redirect "
            f"to leader rank {leader} (replay with the same write_id — "
            f"the seq-dedup map makes the retry idempotent)")
        self.leader = int(leader)
        self.rank = rank


class StreamingKnnService(Service):
    """Batched IVF-Flat kNN against a live streaming index: the body is
    :func:`ivf_flat._search_body` with the epoch's tombstone words as a
    sixth fixed operand, so deleted rows are masked in the scan.

    The fixed operands are a snapshot that :meth:`prepare` and
    :meth:`publish` roll forward: ``prepare()`` makes the serving tuple
    of the stream's current snapshot (a new epoch iff a shape or static
    changed), ``publish()`` installs it; :meth:`refresh` does both with
    no pre-warm. One instance per (k, nprobe), ``0 < nprobe < n_lists``
    (a full scan is :meth:`StreamingIndex.search`'s exact path), k at
    most the live rows."""

    def __init__(self, stream: StreamingIndex, k: int, nprobe: int):
        flat = stream.flat
        if not 0 < nprobe < flat.n_lists:
            raise ValueError(
                f"StreamingKnnService needs 0 < nprobe < n_lists "
                f"(got nprobe={nprobe}, n_lists={flat.n_lists}); "
                f"nprobe >= n_lists is a full scan — serve it through "
                f"StreamingIndex.search's exact path")
        self.stream = stream
        self.k = int(k)
        self.nprobe = int(nprobe)
        self.name = f"stream_knn_k{k}_np{nprobe}_{flat.metric}"
        super().__init__((), dim=flat.dim, dtype=flat.packed_db.dtype)
        self._version = -1
        pending, version = self.prepare()
        self.publish(pending, version)

    # -- snapshot roll-forward ----------------------------------------

    def prepare(self) -> Optional[Tuple[Tuple, int]]:
        """``(pending_serving, stream_version)`` for the stream's current
        snapshot, or None when it is already served. The pending epoch
        is one more than the served one iff an operand's shape or dtype,
        or a static, differs."""
        snap = self.stream.snapshot
        if snap.version == self._version:
            return None
        from raft_tpu_torch.neighbors.ivf_flat import _use_radix

        flat = snap.flat
        probe_rows = self.nprobe * flat.cap_max
        if probe_rows < self.k:
            raise ValueError(
                f"{self.name}: nprobe={self.nprobe} reaches at most "
                f"{probe_rows} candidates < k={self.k} after the "
                f"latest repack; raise nprobe")
        fixed = (flat.centroids, flat.packed_db, flat.packed_ids,
                 flat.starts, flat.sizes, snap.tomb_words)
        statics: Dict[str, object] = {
            "cap_max": int(flat.cap_max),
            "metric": flat.metric,
            "use_radix": bool(_use_radix(probe_rows, self.k)),
        }
        epoch, cur_fixed, cur_statics = self.serving()
        same = (cur_statics == statics
                and len(cur_fixed) == len(fixed)
                and all(a.shape == b.shape and a.dtype == b.dtype
                        for a, b in zip(cur_fixed, fixed)))
        return (epoch + (0 if same else 1), fixed, statics), snap.version

    def publish(self, pending: Tuple, version: int) -> bool:
        """Install a prepared serving tuple (one writer: the
        controller's serve lock) in one attribute store. True when the
        epoch advanced."""
        changed = pending[0] != self.serve_epoch
        self._serving = pending
        self._version = int(version)
        return changed

    def refresh(self) -> bool:
        """:meth:`prepare` and :meth:`publish` with no pre-warm (the next
        launch at a new epoch builds inline). True when the epoch
        advanced."""
        p = self.prepare()
        if p is None:
            return False
        return self.publish(*p)

    # -- Service surface ----------------------------------------------

    def _build_for(self, serving: Tuple):
        from raft_tpu_torch.neighbors.ivf_flat import _search_body
        from raft_tpu_torch.util.precision import scope

        k, nprobe = self.k, self.nprobe
        st = serving[2]
        cap_max, metric = st["cap_max"], st["metric"]
        use_radix = st["use_radix"]

        def fn(centroids, packed_db, packed_ids, starts, sizes,
               tomb_words, q):
            with scope():
                return _search_body(q, centroids, packed_db, packed_ids,
                                    starts, sizes, tomb_words, k=k,
                                    nprobe=nprobe, cap_max=cap_max,
                                    metric=metric, use_radix=use_radix)
        return fn

    def unpack(self, out, start, rows):
        d, i = out
        return d[start:start + rows], i[start:start + rows]

    def estimate_bytes(self, rows):
        _, fixed, st = self.serving()
        return limits.estimate_bytes(
            "neighbors.ivf_search", n_queries=rows,
            probe_rows=self.nprobe * st["cap_max"],
            n_dims=self.dim, k=self.k, itemsize=fixed[1].element_size(),
            packed_rows=int(fixed[1].shape[0]))

    def eager(self, queries):
        return self.stream.search(self.queries(queries), self.k,
                                  self.nprobe)

    def epilogue(self) -> str:
        """"ivf", quoted from :func:`knn_plan` as the static kNN services
        do."""
        from raft_tpu_torch.neighbors.brute_force import knn_plan

        flat = self.stream.flat
        path, _ = knn_plan(1, flat.n_db, self.k, metric=flat.metric,
                           n_lists=flat.n_lists, nprobe=self.nprobe)
        return path


class IngestController:
    """The serving trio, :class:`StreamingIndex`, :class:`Executor` and
    :class:`Compactor`, wired so every mutation reaches the serve path
    as an atomic snapshot swap, pre-warmed when shapes change.

    Foreground :meth:`insert`/:meth:`delete` mutate the stream, then roll
    the streaming services forward inline (a shape-changing repack pays
    its re-warm on the ingest call, never on a query); background
    compaction and refit arrive through the compactor's ``on_change`` on
    its worker. One serve lock orders the two. The controller runs on
    the stream's device.

    ``rewarm_traces`` counts the compile events (exports, kernel builds,
    graph captures) the pre-warms made, and ``rewarm_windows`` their
    ``(start, end)`` monotonic seconds: the executor's ``stats.traces``
    less these and ``warm()``'s is what the query path compiled.

    ``election``: any object with the reference's election attributes
    (``index``, ``is_leader()``, ``leader``, ``rank``, ``role``,
    ``start()``, ``stop()`` and the ``on_promote``/``on_repoint``/
    ``on_demote`` hooks); with one a follower's mutation raises
    :class:`NotLeaderError`. ``None`` is the single-node regime."""

    def __init__(self, stream: StreamingIndex,
                 services: Sequence[StreamingKnnService], *,
                 queue=None, policy=None, qos=None, use_aot: bool = True,
                 brownout=None, faults=None,
                 compact_interval: Optional[float] = None,
                 tombstone_frac: Optional[float] = None,
                 refit: bool = True,
                 warm_buckets: Optional[Sequence[int]] = None,
                 extra_services: Sequence[Service] = (),
                 shipper=None, election=None):
        self.stream = stream
        self.streaming_services: List[StreamingKnnService] = \
            list(services)
        for svc in self.streaming_services:
            if svc.stream is not stream:
                raise ValueError(
                    f"service {svc.name} wraps a different "
                    f"StreamingIndex than this controller's")
        self.executor = Executor(
            [*self.streaming_services, *extra_services], queue=queue,
            policy=policy, qos=qos, use_aot=use_aot, brownout=brownout,
            faults=faults)
        self.compactor = Compactor(
            stream, interval=compact_interval,
            tombstone_frac=tombstone_frac, refit=refit,
            on_change=self._on_index_change)
        # a WAL shipper replicating this stream's journal, attached and
        # started with the controller
        self.shipper = shipper
        if shipper is not None and shipper.index is not stream:
            raise ValueError(
                "shipper replicates a different StreamingIndex than "
                "this controller's")
        # an election node makes the controller leader-aware; it owns
        # the shipper while leading, so the two are exclusive
        self.election = election
        if election is not None:
            if shipper is not None:
                raise ValueError(
                    "pass shipper= OR election= — the election node "
                    "owns the WAL shipper across role changes")
            if election.index is not stream:
                raise ValueError(
                    "election node coordinates a different "
                    "StreamingIndex than this controller's")
            self._wire_election(election)
        self._serve_lock = threading.Lock()
        self._warm_buckets = (list(warm_buckets)
                              if warm_buckets is not None else None)
        self.refreshes = 0   # snapshot publishes (any swap)
        self.swaps = 0       # epoch-bumped publishes (shape changed)
        self.rewarm_traces = 0
        self.rewarm_windows: List[Tuple[float, float]] = []

    def _buckets(self) -> Sequence[int]:
        if self._warm_buckets is not None:
            return self._warm_buckets
        return bucket_ladder(self.executor.queue.policy.max_batch)

    # -- lifecycle ----------------------------------------------------

    def start(self, *, warm: bool = True) -> "IngestController":
        if warm:
            self.executor.warm(self._buckets())
        if self.shipper is not None:
            self.shipper.attach()
            self.shipper.start()
        if self.election is not None:
            self.election.start()
        self.executor.start()
        self.compactor.start()
        return self

    def stop(self) -> None:
        """Compactor first (no swap lands while the executor drains),
        then the executor, then the shipper and the election; a worker's
        failure is raised here, after the drain."""
        try:
            self.compactor.stop()
        finally:
            try:
                self.executor.stop()
            finally:
                try:
                    if self.shipper is not None:
                        try:
                            self.shipper.stop()
                        finally:
                            self.shipper.detach()
                finally:
                    if self.election is not None:
                        self.election.stop()

    def __enter__(self) -> "IngestController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- leader awareness ---------------------------------------------

    def is_leader(self) -> bool:
        """True when this controller takes writes (always, with no
        election)."""
        return self.election is None or self.election.is_leader()

    @property
    def leader(self) -> Optional[int]:
        """The fleet's leader rank (None with no election)."""
        return None if self.election is None else self.election.leader

    def _require_leader(self) -> None:
        el = self.election
        if el is not None and not el.is_leader():
            if obs.enabled():
                obs.inc("serve_not_leader_rejects_total")
            raise NotLeaderError(leader=el.leader, rank=el.rank)

    def _wire_election(self, election) -> None:
        """Chain the controller into the node's role-change hooks: a
        role change rolls the serving snapshot forward on the node's
        thread (a promotion moves no rows, so no shape changes; a
        demotion's resync may, and pays its re-warm here)."""
        def chain(prev):
            def hook(node):
                self._on_index_change()
                obs.emit_event("serve.ingest_role_change",
                               role=node.role, term=node.index.term,
                               leader=node.leader)
                if prev is not None:
                    prev(node)
            return hook
        election.on_promote = chain(election.on_promote)
        election.on_repoint = chain(election.on_repoint)
        election.on_demote = chain(election.on_demote)

    # -- ingest surface -----------------------------------------------

    def insert(self, rows, labels: Optional[np.ndarray] = None, *,
               write_id: Optional[int] = None) -> np.ndarray:
        """Journal and apply an insert, then roll the serving snapshot
        forward; returns the ids. A follower raises
        :class:`NotLeaderError`."""
        self._require_leader()
        ids = self.stream.insert(rows, labels, write_id=write_id)
        self._on_index_change()
        return ids

    def delete(self, ids) -> int:
        """Tombstone ids, then publish (always same-shape). A follower
        raises :class:`NotLeaderError`."""
        self._require_leader()
        n = self.stream.delete(ids)
        self._on_index_change()
        return n

    def compact(self, *, reason: str = "manual") -> None:
        """A foreground compaction (the worker's
        :meth:`Compactor.run_once` does the same)."""
        self.stream.compact(reason=reason)
        self._on_index_change()

    def submit(self, op: str, queries, **kw):
        return self.executor.submit(op, queries, **kw)

    # -- snapshot roll-forward ----------------------------------------

    def _on_index_change(self) -> None:
        """Roll every streaming service forward, pre-warming before the
        publish when shapes changed. Runs on the thread that mutated the
        index; queries never wait on the serve lock."""
        ex = self.executor
        with self._serve_lock:
            for svc in self.streaming_services:
                p = svc.prepare()
                if p is None:
                    continue
                pending, version = p
                bumped = pending[0] != svc.serve_epoch
                if bumped:
                    t0 = time.monotonic()
                    traces0 = ex.stats.traces
                    buckets = list(self._buckets())
                    for b in buckets:
                        exe = ex._get_executable(svc, b, pending)
                        ex._call(svc, exe, pending[1], svc.example(b),
                                 ex._tier(svc, pending[0]))
                    t1 = time.monotonic()
                    self.rewarm_windows.append((t0, t1))
                    # exports count as they trace, builds and captures
                    # in _call
                    self.rewarm_traces += ex.stats.traces - traces0
                    obs.emit_event(
                        "serve.ingest_rewarm", service=svc.name,
                        epoch=pending[0], buckets=buckets,
                        seconds=round(t1 - t0, 4))
                svc.publish(pending, version)
                self.refreshes += 1
                if bumped:
                    self.swaps += 1
                    obs.inc("serve_streaming_swaps_total", 1,
                            service=svc.name)
