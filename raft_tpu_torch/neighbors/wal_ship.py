"""WAL shipping: the streaming index's mutation log replicated over the
mailbox transport (counterpart of ``raft_tpu/neighbors/wal_ship.py``).

One journaled :class:`~raft_tpu_torch.neighbors.streaming.StreamingIndex`
survives its own crash; this module lets a replica whose disk is gone
catch up from a live peer instead:

- the **leader** (:class:`WalShipper`) subscribes to
  :attr:`MutationLog.on_append` and sends every durable WAL record to
  each follower as it commits (record first, then ship: a shipped record
  is never less durable at the source than anywhere else). It answers
  catch-up requests from its WAL on disk, or with the epoch snapshot
  itself when the range asked for was already pruned;
- the **follower** (:class:`WalFollower`) applies records in strict
  sequence order and mirrors each into its own journal first
  (``append_mirror`` keeps the leader's numbering, so the follower's WAL
  is a suffix of the leader's and a restart resumes at the right
  cursor). A gap raises the typed
  :class:`~raft_tpu_torch.neighbors.streaming.WalGapError`, which
  :meth:`WalFollower.drain` turns into a snapshot resync through
  :meth:`WalFollower.catch_up`.

Wire format: every frame is a v1 checkpoint container of
:mod:`raft_tpu_torch.core.checkpoint` (the WAL's per-entry CRCs) held in
a uint8 array, as the TCP mailbox carries numpy payloads. The bytes of a
frame are the reference package's for the same entries, so a leader of
either package feeds a follower of either. Delivery is at least once per
link and FIFO; the follower drops duplicates by sequence number, so a
gap means records were pruned or lost, never reordered.

Threads: the shipper's poller and a follower's drain touch the index's
tensors from their own threads. Every tensor the index makes names its
device explicitly (the index's ``device``), never the thread's current
one.
"""

from __future__ import annotations

import collections
import io
import struct
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.comms.errors import PeerFailedError
from raft_tpu_torch.core import env, trace
from raft_tpu_torch.core.checkpoint import (CheckpointError, dump_checkpoint,
                                            load_checkpoint)
from raft_tpu_torch.neighbors.streaming import (KIND_CENTROIDS, KIND_DELETE,
                                                KIND_INSERT, KIND_TERM,
                                                MutationLog, StreamingError,
                                                StreamingIndex,
                                                TermFencedError, WalGapError,
                                                _device_of, _epoch_entries,
                                                _flat_from_live, _host_rows)

__all__ = [
    "TAG_WAL", "TAG_CATCHUP_REQ", "TAG_CATCHUP", "TAG_WAL_ACK",
    "FRAME_WAL", "FRAME_SNAPSHOT", "FRAME_END",
    "encode_frame", "decode_frame", "frame_kind",
    "WalFrameError", "WalQuorumError",
    "WalShipper", "WalFollower", "CatchupReport", "bootstrap_follower",
]

# mailbox tags, high enough never to meet the solver protocols that
# share a clique's mailbox
TAG_WAL = 7301          # leader -> follower: one live WAL record
TAG_CATCHUP_REQ = 7302  # follower -> leader: {"from_seq": n}
TAG_CATCHUP = 7303      # leader -> follower: the catch-up frames
TAG_WAL_ACK = 7304      # follower -> leader: {"applied", "rank", "term"}

FRAME_WAL = 0       # one WAL record (MutationLog.append's keys and seq)
FRAME_SNAPSHOT = 1  # a whole epoch's entries (the gap is too wide)
FRAME_END = 2       # {"through_seq": n}: the end of a catch-up stream

_FRAME_KINDS = (FRAME_WAL, FRAME_SNAPSHOT, FRAME_END)


class WalFrameError(StreamingError):
    """A wire frame failed to encode, decode or name its kind: a damaged
    payload (bit flip, truncation), a message that is not a frame on a
    frame tag, or an unknown ``_frame`` kind."""


class WalQuorumError(StreamingError):
    """A quorum-acked mutation timed out before enough followers
    confirmed its sequence durable in their mirror journals. The write
    is durable on the leader (journal first): the caller treats it as
    indeterminate and retries idempotently (``write_id``), never as
    lost."""

    def __init__(self, *, seq: int, acked: int, needed: int):
        super().__init__(
            f"quorum ack timeout: seq {seq} confirmed by {acked} "
            f"follower(s), needed {needed} — write is durable locally "
            f"but NOT quorum-replicated; retry idempotently")
        self.seq = int(seq)
        self.acked = int(acked)
        self.needed = int(needed)


def encode_frame(entries: Dict) -> np.ndarray:
    """A frame dict as a uint8 array: the CRC'd v1 checkpoint container
    the WAL writes, so one integrity format guards rest and wire. Raises
    :class:`WalFrameError` on a frame that cannot be serialized."""
    bio = io.BytesIO()
    try:
        dump_checkpoint(entries, bio)
    except (CheckpointError, KeyError, ValueError, TypeError) as exc:
        raise WalFrameError(f"frame encode failed: {exc}") from exc
    return np.frombuffer(bio.getvalue(), np.uint8)


def decode_frame(payload: np.ndarray) -> Dict:
    """Inverse of :func:`encode_frame`. A damaged payload (bit flip,
    truncation, another format) raises :class:`WalFrameError` with the
    cause chained, never the container's own error types."""
    try:
        raw = np.asarray(payload, np.uint8).tobytes()
        return load_checkpoint(io.BytesIO(raw))
    except (CheckpointError, KeyError, ValueError, TypeError,
            EOFError, OSError, struct.error) as exc:
        raise WalFrameError(f"frame decode failed: {exc}") from exc


def frame_kind(frame: Dict) -> int:
    """The ``_frame`` kind of a decoded frame; raises
    :class:`WalFrameError` when the tag is missing or unknown (a whole
    container that is not a protocol frame)."""
    try:
        kind = int(frame["_frame"])
    except (KeyError, TypeError, ValueError) as exc:
        raise WalFrameError(
            f"frame has no usable _frame tag: {exc}") from exc
    if kind not in _FRAME_KINDS:
        raise WalFrameError(f"unknown _frame kind {kind}")
    return kind


@dataclass
class CatchupReport:
    """What one :meth:`WalFollower.catch_up` round did."""

    records: int          # WAL records replayed
    snapshot: bool        # True when the leader resynced by snapshot
    seconds: float
    from_seq: int         # first sequence asked for
    through_seq: int      # the leader's applied horizon when it served


class WalShipper:
    """Leader-side WAL replication of one :class:`StreamingIndex`.

    :meth:`attach` subscribes to the journal's ``on_append``, so every
    durable record goes to each follower rank on ``TAG_WAL``; the poller
    (:meth:`start`) answers ``TAG_CATCHUP_REQ`` from the WAL on disk, or
    with a whole epoch snapshot when the range was already pruned (or
    the follower asks from sequence 0: the build's epoch 0 never passes
    through the WAL). A dead follower's send errors are counted
    (``ship_errors``, ``wal_ship_errors_total``) and tolerated: the
    leader's mutations and the poller go on, and catch-up heals the
    follower when it returns. Any other worker error is raised at
    :meth:`stop`.
    """

    def __init__(self, index: StreamingIndex, mailbox, rank: int,
                 followers: Iterable[int], *,
                 poll_interval: float = 0.05,
                 acks: "str | int | None" = None,
                 ack_timeout: float = 10.0):
        if index.log is None:
            raise StreamingError(
                "WAL shipping needs a journaled index (directory=...)")
        self.index = index
        self.mailbox = mailbox
        self.rank = int(rank)
        self.followers = [int(f) for f in followers]
        if self.rank in self.followers:
            raise ValueError(f"rank {self.rank} cannot follow itself")
        self.poll_interval = float(poll_interval)
        if acks is None:
            acks = env.read("RAFT_TPU_WAL_QUORUM")
        if isinstance(acks, str) and acks not in ("async", "majority",
                                                  "all"):
            raise ValueError(
                f"acks must be 'async', 'majority', 'all' or a "
                f"positive follower count, got {acks!r}")
        if not isinstance(acks, str) and int(acks) < 1:
            raise ValueError(f"acks count must be >= 1, got {acks}")
        self.acks = acks
        self.ack_timeout = float(ack_timeout)
        self.shipped = 0
        self.ship_errors = 0
        self.catchups_served = 0
        self.quorum_waits = 0
        # each follower's highest acked sequence, and a bounded seq ->
        # send time map for the wal_replication_lag_seconds gauge
        self._acked: Dict[int, int] = {}
        self._sent_at: "collections.OrderedDict[int, float]" = \
            collections.OrderedDict()
        self._ack_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def acks_needed(self) -> int:
        """Follower confirmations a mutation waits for before it returns
        (the leader's own journal is the extra vote): 0 in async mode,
        ceil((n+1)/2) - 1 for a majority of the n+1 nodes, every follower
        for ``all``, else the count given (at most the followers)."""
        if self.acks == "async":
            return 0
        n = len(self.followers) + 1            # fleet size with leader
        if self.acks == "majority":
            return max((n + 1 + 1) // 2 - 1, 0)
        if self.acks == "all":
            return len(self.followers)
        return min(int(self.acks), len(self.followers))

    # -- live shipping -------------------------------------------------

    def attach(self) -> "WalShipper":
        """Subscribe to the journal's appends. One shipper may source a
        journal (two would ship every record twice); other subscribers
        (an election node, a scrub trigger) coexist. Attaching the same
        shipper again is a no-op. A quorum ack mode also installs the
        index's commit barrier, so ``insert()``/``delete()`` wait for the
        followers."""
        log = self.index.log
        other = getattr(log, "_shipper", None)
        if other is self:
            return self
        if other is not None:
            raise StreamingError(
                "journal already has an on_append WAL-shipping hook")
        log._shipper = self
        log.add_on_append(self._on_append)
        if self.acks_needed() > 0:
            self.index._commit_barrier = self._quorum_barrier
        return self

    def detach(self) -> None:
        """Unsubscribe from the journal and remove the commit barrier
        (bound methods, found by equality: each attribute access makes a
        new one)."""
        log = self.index.log
        if getattr(log, "_shipper", None) is self:
            log._shipper = None
        log.remove_on_append(self._on_append)
        if self.index._commit_barrier == self._quorum_barrier:
            self.index._commit_barrier = None

    def _on_append(self, rec: Dict) -> None:
        fr = dict(rec)
        fr["_frame"] = FRAME_WAL
        payload = encode_frame(fr)
        with self._ack_lock:
            self._sent_at[int(rec["seq"])] = time.monotonic()
            while len(self._sent_at) > 4096:
                self._sent_at.popitem(last=False)
        ok = 0
        for f in self.followers:
            # a dead follower never fails the leader's mutation: the
            # record is durable here and catch-up heals the follower
            try:
                self.mailbox.put(self.rank, f, TAG_WAL, payload)
                ok += 1
            except (PeerFailedError, OSError) as exc:
                self.ship_errors += 1
                trace.record_event("wal_ship.ship_failed", follower=f,
                                   seq=int(rec["seq"]), error=repr(exc))
                if obs.enabled():
                    obs.inc("wal_ship_errors_total")
        self.shipped += 1
        if obs.enabled() and ok:
            obs.inc("wal_records_shipped_total", ok)

    # -- replication acks ---------------------------------------------

    def drain_acks(self) -> int:
        """Fold every queued follower ack into the acked cursors and the
        ``wal_replication_lag_seconds`` gauge; returns how many. Runs on
        the poller and inside the quorum wait: both only advance a
        cursor."""
        n = 0
        for f in self.followers:
            while True:
                payload = self.mailbox.get_nowait(f, self.rank,
                                                  TAG_WAL_ACK)
                if payload is None:
                    break
                try:
                    ack = decode_frame(payload)
                    applied = int(ack["applied"])
                except (WalFrameError, KeyError, ValueError) as exc:
                    trace.record_event("wal_ship.bad_ack", follower=f,
                                       error=repr(exc))
                    continue
                n += 1
                with self._ack_lock:
                    prev = self._acked.get(f, -1)
                    self._acked[f] = max(prev, applied)
                    sent = self._sent_at.get(applied)
                if sent is not None and obs.enabled():
                    obs.set_gauge("wal_replication_lag_seconds",
                                  time.monotonic() - sent,
                                  follower=str(f))
        return n

    def acked_seq(self, follower: int) -> int:
        """Highest sequence this follower confirmed durable."""
        with self._ack_lock:
            return self._acked.get(int(follower), -1)

    def _quorum_barrier(self, seq: int) -> None:
        """Hold the committing mutation until ``acks_needed()``
        followers confirmed ``seq``. Installed as the index's commit
        barrier in the quorum modes; it runs after the local journal and
        apply, outside the index's lock, so a timeout leaves the leader
        consistent and raises :class:`WalQuorumError`."""
        need = self.acks_needed()
        if need <= 0:
            return
        self.quorum_waits += 1
        deadline = time.monotonic() + self.ack_timeout
        while True:
            self.drain_acks()
            with self._ack_lock:
                got = sum(1 for f in self.followers
                          if self._acked.get(f, -1) >= seq)
            if got >= need:
                return
            if time.monotonic() >= deadline:
                if obs.enabled():
                    obs.inc("wal_quorum_timeouts_total")
                raise WalQuorumError(seq=seq, acked=got, needed=need)
            time.sleep(0.001)

    # -- catch-up service ---------------------------------------------

    def serve_catchup_once(self) -> int:
        """Answer every queued catch-up request; returns how many."""
        served = 0
        for f in self.followers:
            req = self.mailbox.get_nowait(f, self.rank, TAG_CATCHUP_REQ)
            while req is not None:
                try:
                    self._serve(f, int(decode_frame(req)["from_seq"]))
                    served += 1
                except (PeerFailedError, OSError) as exc:
                    # the follower died mid-stream: drop this round and
                    # keep polling; it asks again when it restarts
                    self.ship_errors += 1
                    trace.record_event("wal_ship.serve_failed",
                                       follower=f, error=repr(exc))
                    if obs.enabled():
                        obs.inc("wal_ship_errors_total")
                    break
                req = self.mailbox.get_nowait(f, self.rank,
                                              TAG_CATCHUP_REQ)
        return served

    def _serve(self, follower: int, from_seq: int) -> None:
        # take (records, horizon, entries) together under the mutation
        # lock: a mutation racing the walk could journal a record newer
        # than the entries shipped
        with self.index._lock:
            recs = {int(r["seq"]): r
                    for r in self.index.log.wal_records()}
            last = self.index._applied_seq
            want = list(range(max(from_seq, 0), last + 1))
            gap = from_seq <= 0 or any(s not in recs for s in want)
            snap = _epoch_entries(self.index) if gap else None
        frames: List[Dict] = []
        if snap is not None:
            snap = dict(snap)
            snap["_frame"] = FRAME_SNAPSHOT
            frames.append(snap)
            through = int(snap["wal_horizon"])
        else:
            for s in want:
                rec = dict(recs[s])
                rec["_frame"] = FRAME_WAL
                frames.append(rec)
            through = last
        frames.append({"_frame": FRAME_END, "through_seq": through})
        for fr in frames:
            self.mailbox.put(self.rank, follower, TAG_CATCHUP,
                             encode_frame(fr))
        self.catchups_served += 1
        trace.record_event("wal_ship.serve_catchup", follower=follower,
                           from_seq=from_seq, through_seq=through,
                           snapshot=snap is not None)

    # -- worker thread -------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.serve_catchup_once()
                self.drain_acks()
            except Exception as exc:  # noqa: BLE001 — raised at stop
                self._error = exc
                obs.record_failure(exc)
                trace.record_event("wal_ship.shipper_error",
                                   error=str(exc))
                return

    def start(self) -> "WalShipper":
        if self._thread is not None:
            raise StreamingError("shipper already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="raft-tpu-wal-shipper")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the poller and raise any failure it died on."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise StreamingError("wal shipper failed") from err

    def __enter__(self) -> "WalShipper":
        self.attach()
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
        self.detach()


class WalFollower:
    """Follower-side WAL application of one :class:`StreamingIndex`.

    Records apply in strict sequence order: a duplicate (at-least-once
    delivery) is skipped, a gap raises
    :class:`~raft_tpu_torch.neighbors.streaming.WalGapError`, which
    :meth:`drain` turns into a :meth:`catch_up` round with the leader
    (records while its WAL has them, else an
    :meth:`~raft_tpu_torch.neighbors.streaming.StreamingIndex
    .install_snapshot` resync). Every record is mirrored into the
    follower's own journal first, under the leader's numbering, so a
    killed follower restarts from its epoch and mirrored WAL at the
    right cursor.
    """

    def __init__(self, index: StreamingIndex, mailbox, rank: int,
                 leader: int, *, send_acks: bool = True):
        self.index = index
        self.mailbox = mailbox
        self.rank = int(rank)
        self.leader = int(leader)
        if self.rank == self.leader:
            raise ValueError(f"rank {self.rank} cannot follow itself")
        self.send_acks = bool(send_acks)
        self.applied = 0
        self.dups = 0
        self.resyncs = 0
        self.fenced = 0

    @property
    def applied_seq(self) -> int:
        """Highest sequence folded into the follower's index (its
        catch-up cursor, kept across a restart by the mirrored
        journal)."""
        return self.index._applied_seq

    def repoint(self, new_leader: int) -> None:
        """Follow a new leader (an election loser's step): live records
        and catch-up rounds now come from ``new_leader``; the cursor and
        the mirrored journal carry over, as sequence numbers are
        fleet-wide."""
        new_leader = int(new_leader)
        if new_leader == self.rank:
            raise ValueError(
                f"rank {self.rank} cannot follow itself")
        old, self.leader = self.leader, new_leader
        trace.record_event("wal_ship.repoint", old_leader=old,
                           new_leader=new_leader, rank=self.rank)

    # -- record application -------------------------------------------

    def _ack(self) -> None:
        """Confirm the durable cursor to the leader: the quorum vote and
        the lag gauge's sample (sent in async mode too). A dead leader is
        tolerated: the ack is advisory and the election sees the
        death."""
        if not self.send_acks:
            return
        try:
            self.mailbox.put(
                self.rank, self.leader, TAG_WAL_ACK,
                encode_frame({"applied": self.index._applied_seq,
                              "rank": self.rank,
                              "term": self.index._term}))
        except (PeerFailedError, OSError):
            pass

    def apply_record(self, rec: Dict) -> bool:
        """Mirror and apply one shipped record; True when it advanced
        the index, False for a duplicate. Raises :class:`WalGapError`
        when ``rec`` is not the next sequence, and
        :class:`~raft_tpu_torch.neighbors.streaming.TermFencedError` when
        it carries a term older than this replica's at or past the
        term's boundary (a deposed leader's write), before it touches
        the journal."""
        seq = int(rec["seq"])
        with self.index._lock:
            term = int(rec.get("term", 0))
            cur = self.index._term
            if term < cur and seq >= self.index._term_start:
                # fence first: a stale-term record at or past the
                # current term's boundary is a deposed leader's write
                # (even as a duplicate seq). Records below the boundary
                # carry older terms by right (catch-up replays history)
                # and go on to the duplicate and gap checks
                self.fenced += 1
                if obs.enabled():
                    obs.inc("wal_fenced_records_total")
                raise TermFencedError(
                    stale_term=term, current_term=cur,
                    divergence=self.index._term_start)
            applied = self.index._applied_seq
            if seq <= applied:
                self.dups += 1
                return False
            if seq != applied + 1:
                raise WalGapError(expected=applied + 1, got=seq)
            if self.index.log is not None:
                self.index.log.append_mirror(
                    {k: v for k, v in rec.items() if k != "_frame"})
            # applied before the dispatch, as recovery replays: an apply
            # that repacks folds this record into its epoch, so the
            # horizon must cover it
            self.index._applied_seq = seq
            if term > cur:
                self.index._term = term
            kind = int(rec["kind"])
            if kind == KIND_INSERT:
                ids = self.index._apply_insert(
                    _host_rows(rec["data"]),
                    np.asarray(rec["labels"], np.int64), journal=False)
                if "write_id" in rec:
                    self.index.note_write_id(int(rec["write_id"]), ids)
            elif kind == KIND_DELETE:
                self.index._apply_delete(
                    np.asarray(rec["data"], np.int64), journal=False)
            elif kind == KIND_CENTROIDS:
                self.index._repack_locked(
                    centroids=np.asarray(rec["data"], np.float32),
                    reason="refit_shipped")
            elif kind == KIND_TERM:
                new_t = int(np.asarray(rec["data"]).ravel()[0])
                self.index._term = max(self.index._term, new_t)
                self.index._term_start = seq
            else:
                raise StreamingError(
                    f"unknown shipped WAL record kind {kind}")
        self.applied += 1
        return True

    def drain(self, *, resync: bool = True) -> int:
        """Apply every queued live record; returns how many advanced the
        index. A gap starts a :meth:`catch_up` when ``resync`` (the
        steady loop), else propagates. Confirms the cursor to the leader
        after a batch that saw records (duplicates too: a resend needs
        its re-ack)."""
        n = 0
        saw = 0
        try:
            while True:
                payload = self.mailbox.get_nowait(self.leader,
                                                  self.rank, TAG_WAL)
                if payload is None:
                    return n
                rec = decode_frame(payload)
                if frame_kind(rec) != FRAME_WAL:
                    raise WalFrameError(
                        f"expected FRAME_WAL on TAG_WAL, got "
                        f"{rec.get('_frame')!r}")
                saw += 1
                try:
                    if self.apply_record(rec):
                        n += 1
                except WalGapError:
                    if not resync:
                        raise
                    rpt = self.catch_up()
                    n += rpt.records
                    # offer the gapped record again: past the catch-up's
                    # horizon it still applies
                    if int(rec["seq"]) > self.index._applied_seq:
                        if self.apply_record(rec):
                            n += 1
        finally:
            if saw:
                self._ack()

    # -- catch-up ------------------------------------------------------

    def catch_up(self, *, timeout: Optional[float] = None
                 ) -> CatchupReport:
        """One request and reply with the leader: ask for everything
        past the cursor, fold the reply (records or a whole snapshot)
        and report. Metered as ``replica_catchup_seconds``."""
        t0 = time.monotonic()
        from_seq = self.index._applied_seq + 1
        self.mailbox.put(self.rank, self.leader, TAG_CATCHUP_REQ,
                         encode_frame({"from_seq": from_seq}))
        records = 0
        snapshot = False
        through = self.index._applied_seq
        while True:
            frame = decode_frame(
                self.mailbox.get(self.leader, self.rank, TAG_CATCHUP,
                                 timeout))
            kind = frame_kind(frame)
            if kind == FRAME_END:
                through = int(frame["through_seq"])
                break
            if kind == FRAME_SNAPSHOT:
                self.index.install_snapshot(frame)
                snapshot = True
                self.resyncs += 1
            elif self.apply_record(frame):
                # a gap inside the served stream is a protocol error:
                # WalGapError propagates; duplicates are fine
                records += 1
        self._ack()
        dt = time.monotonic() - t0
        if obs.enabled():
            obs.observe("replica_catchup_seconds", dt)
            obs.inc("replica_catchups_total",
                    outcome="snapshot" if snapshot else "records")
        trace.record_event("wal_ship.catch_up", from_seq=from_seq,
                           through_seq=through, records=records,
                           snapshot=snapshot, seconds=round(dt, 4))
        return CatchupReport(records=records, snapshot=snapshot,
                             seconds=dt, from_seq=from_seq,
                             through_seq=through)


def bootstrap_follower(res, *, dim: int, n_lists: int,
                       metric: str = "l2",
                       directory: Optional[str] = None,
                       faults=None,
                       retain: Optional[int] = None) -> StreamingIndex:
    """A blank follower index (no rows, zero centroids) on the handle's
    device (``cuda:0`` for ``res=None``, which raises without CUDA). Its
    first :meth:`WalFollower.catch_up` asks from sequence 0 and so
    resyncs by snapshot (the leader's whole epoch entries, trained
    centroids included): a new replica reaches the leader's
    ``content_crc`` with no history of its own."""
    device = _device_of(res)
    flat = _flat_from_live(
        torch.zeros((0, dim), dtype=torch.float32, device=device),
        np.zeros((0,), np.int64),
        torch.zeros((n_lists, dim), dtype=torch.float32, device=device),
        metric)
    log = (MutationLog(directory, retain=retain)
           if directory is not None else None)
    return StreamingIndex(flat, log=log, res=res, faults=faults)
