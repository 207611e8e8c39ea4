"""Leader failover of the replicated streaming fleet: term-fenced
election and promotion that moves no data (counterpart of
``raft_tpu/neighbors/election.py``).

WAL shipping (:mod:`raft_tpu_torch.neighbors.wal_ship`) makes a
follower's failure survivable; this module makes the leader's so. Every
node runs an :class:`ElectionNode` beside its
:class:`~raft_tpu_torch.neighbors.wal_ship.WalShipper` (leading) or
:class:`~raft_tpu_torch.neighbors.wal_ship.WalFollower` (following):

- the **leader** sends a heartbeat (term, applied horizon, term
  boundary) to every peer each ``heartbeat_interval``;
- a **follower** that hears nothing for ``RAFT_TPU_ELECTION_TIMEOUT``
  seconds, or whose mailbox's failure detector marks the leader dead,
  runs an election among the survivors (through
  :meth:`~raft_tpu_torch.comms.comms.MeshComms.agree_on_survivors` when
  a comms view is given);
- every survivor sends a round-stamped **ballot** ``(term,
  applied_seq)`` to the others, and all compute the same winner: the
  highest ``(term, applied_seq)``, the lowest rank on a tie. The winner
  holds the most caught-up mirror journal, so **promotion moves no
  data**: it attaches a shipper, journals a :data:`KIND_TERM` record
  under ``max(terms) + 1`` (the durable term boundary, shipped like any
  record) and takes writes. The others follow the winner and adopt the
  term; a backlog heals through catch-up.

**Fencing** makes a deposed leader harmless: one that was only cut off
goes on shipping records stamped with its old term, and every replica
rejects them with the typed
:class:`~raft_tpu_torch.neighbors.streaming.TermFencedError`, which
carries the divergence (the sequence where the new term began). The
deposed node learns of it from a fence message or a higher-term
heartbeat and **demotes**: it truncates its unreplicated WAL suffix from
the divergence (:meth:`MutationLog.truncate_from`), resets its cursor,
rejoins as a follower and heals by snapshot catch-up to the fleet's
``content_crc``.

Ack modes ride the shipper (``acks="majority"``): a write acked by a
quorum survives any single failure; async keeps the latency, and the
``wal_replication_lag_seconds`` gauge measures each follower's window.

Threads: a node's worker applies records and installs snapshots on its
own thread; the index names its device in every tensor it makes.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from raft_tpu_torch import obs
from raft_tpu_torch.comms.errors import (CommsAbortedError, CommsError,
                                         CommsTimeoutError, PeerFailedError)
from raft_tpu_torch.core import env, trace
from raft_tpu_torch.neighbors.streaming import (StreamingError, StreamingIndex,
                                                TermFencedError)
from raft_tpu_torch.neighbors.wal_ship import (WalFollower, WalFrameError,
                                               WalShipper, decode_frame,
                                               encode_frame)

__all__ = [
    "TAG_HEARTBEAT", "TAG_BALLOT", "TAG_FENCE",
    "ElectionError", "ElectionRecord", "ElectionNode",
]

# Both failover knobs are read at import: a malformed election timeout
# or quorum mode fails the import, not the first failover.
env.read("RAFT_TPU_ELECTION_TIMEOUT")
env.read("RAFT_TPU_WAL_QUORUM")

# mailbox tags, the failover band above WAL shipping's
TAG_HEARTBEAT = 7310  # leader -> all: {"term", "applied", "term_start"}
TAG_BALLOT = 7311     # survivor <-> survivor: {"round", "term", "applied"}
TAG_FENCE = 7312      # replica -> stale leader: {"term", "term_start",
#                       "leader"}, the explicit "you are deposed"


class ElectionError(StreamingError):
    """The survivors could not complete an election (no quorum, or a
    participant lost mid-election again and again)."""


@dataclass
class ElectionRecord:
    """What one completed election decided (every survivor records the
    same one)."""

    winner: int                       # promoted rank
    term: int                         # the new term
    round: int                        # this node's election round
    survivors: Tuple[int, ...]        # the ranks that voted
    votes: Dict[int, Tuple[int, int]]  # rank -> (term, applied_seq)
    seconds: float                    # detection to role switch
    promoted: bool = False            # True on the winner's record
    attempts: int = 1                 # survivor-set tries used
    extra: Dict = field(default_factory=dict)


class ElectionNode:
    """One fleet member's failover state machine (see the module
    docstring).

    As ``"leader"`` it heartbeats and watches for rival (higher-term)
    leaders; as ``"follower"`` it drains shipped WAL records, watches the
    leader's pulse and runs the election when the pulse stops. Role
    changes (promotion, re-point, demotion) happen on the node's worker
    thread, or in the caller's through :meth:`run_election` and
    :meth:`tick`. Worker errors are raised at :meth:`stop`.

    Parameters
    ----------
    index : the node's journaled :class:`StreamingIndex`.
    mailbox : the fleet's transport (``TcpMailbox`` or the in-process
        ``_Mailbox``).
    rank / fleet : this node's rank and every fleet rank.
    role : ``"leader"`` or ``"follower"``.
    leader : the current leader's rank.
    comms : optional :class:`~raft_tpu_torch.comms.comms.MeshComms` view
        of this rank; elections then take their survivors from its
        ``agree_on_survivors``, else from the mailbox's failure detector.
    acks : the shipper's ack mode when this node leads (``None`` reads
        ``RAFT_TPU_WAL_QUORUM``).
    on_promote / on_repoint / on_demote : role-change callbacks (the
        serving tier re-routes here), called on the worker thread after
        the data plane switched.
    """

    def __init__(self, index: StreamingIndex, mailbox, rank: int,
                 fleet: List[int], *, role: str, leader: int,
                 comms=None,
                 heartbeat_interval: Optional[float] = None,
                 election_timeout: Optional[float] = None,
                 acks: "str | int | None" = None,
                 ack_timeout: float = 10.0,
                 shipper: Optional[WalShipper] = None,
                 follower: Optional[WalFollower] = None,
                 on_promote: Optional[Callable[["ElectionNode"], None]]
                 = None,
                 on_repoint: Optional[Callable[["ElectionNode"], None]]
                 = None,
                 on_demote: Optional[Callable[["ElectionNode"], None]]
                 = None,
                 poll_interval: float = 0.01):
        if role not in ("leader", "follower"):
            raise ValueError(f"role must be leader|follower, got "
                             f"{role!r}")
        if index.log is None:
            raise StreamingError(
                "failover needs a journaled index (directory=...)")
        self.index = index
        self.mailbox = mailbox
        self.rank = int(rank)
        self.fleet = sorted(int(r) for r in fleet)
        if self.rank not in self.fleet:
            raise ValueError(f"rank {self.rank} not in fleet "
                             f"{self.fleet}")
        self.role = role
        self.leader = int(leader)
        self.comms = comms
        self.election_timeout = float(
            env.read("RAFT_TPU_ELECTION_TIMEOUT")
            if election_timeout is None else election_timeout)
        self.heartbeat_interval = float(
            self.election_timeout / 4.0
            if heartbeat_interval is None else heartbeat_interval)
        self.acks = env.read("RAFT_TPU_WAL_QUORUM") if acks is None \
            else acks
        self.ack_timeout = float(ack_timeout)
        self.poll_interval = float(poll_interval)
        self.on_promote = on_promote
        self.on_repoint = on_repoint
        self.on_demote = on_demote
        self.shipper = shipper
        self.follower = follower
        if role == "leader" and self.shipper is None:
            self.shipper = WalShipper(
                index, mailbox, self.rank,
                [r for r in self.fleet if r != self.rank],
                acks=self.acks, ack_timeout=self.ack_timeout)
        if role == "follower" and self.follower is None:
            self.follower = WalFollower(index, mailbox, self.rank,
                                        self.leader)
        self.elections = 0            # this node's election round
        self.promotions = 0
        self.demotions = 0
        self.fences_sent = 0
        self.last_election: Optional[ElectionRecord] = None
        self.last_fence: Optional[TermFencedError] = None
        self._last_heartbeat = time.monotonic()
        self._lock = threading.Lock()   # role transitions
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- small helpers -------------------------------------------------

    @property
    def peers(self) -> List[int]:
        return [r for r in self.fleet if r != self.rank]

    def is_leader(self) -> bool:
        return self.role == "leader"

    def _put(self, dst: int, tag: int, frame: Dict) -> bool:
        """Best-effort control-plane send: a dead peer never fails the
        node (the failure detector and catch-up heal)."""
        try:
            self.mailbox.put(self.rank, dst, tag, encode_frame(frame))
            return True
        except (PeerFailedError, OSError):
            return False

    def _drain(self, src: int, tag: int) -> List[Dict]:
        """Every queued frame from (src, tag) that decodes, in order; a
        damaged one is dropped with a trace event (the control plane
        sends its state again)."""
        out: List[Dict] = []
        while True:
            payload = self.mailbox.get_nowait(src, self.rank, tag)
            if payload is None:
                return out
            try:
                out.append(decode_frame(payload))
            except WalFrameError as exc:
                trace.record_event("election.bad_frame", src=src,
                                   tag=tag, error=repr(exc))

    # -- heartbeats ----------------------------------------------------

    def _heartbeat_frame(self) -> Dict:
        return {"term": self.index.term,
                "applied": self.index.applied_seq,
                "term_start": self.index._term_start,
                "leader": self.rank}

    def broadcast_heartbeat(self) -> None:
        """The leader's pulse to every peer the mailbox does not hold
        failed. A send to a dead peer can wait out the transport's
        connect retries (seconds, while the peer restarts), and the other
        peers would hear no pulse meanwhile and elect again. A node that
        rejoins is revived by the first frame it sends, and then hears
        the current term."""
        frame = self._heartbeat_frame()
        failed = getattr(self.mailbox, "peer_failed", None)
        for p in self.peers:
            if failed is not None and failed(p):
                continue
            self._put(p, TAG_HEARTBEAT, frame)

    def _observe_heartbeats(self) -> None:
        """Follower side: fold every queued heartbeat. The leader's pulse
        feeds the silence timer; a higher-term pulse from any rank means
        an election happened without this node (it was catching up or
        cut off): adopt it and follow. A lower-term pulse is a deposed
        leader, which is fenced."""
        for p in self.peers:
            beats = self._drain(p, TAG_HEARTBEAT)
            if not beats:
                continue
            hb = beats[-1]
            term = int(hb["term"])
            if term < self.index.term:
                self._send_fence(p)
                continue
            if term > self.index.term:
                self.index.adopt_term(term)
                self.index._term_start = int(hb.get("term_start", 0))
            if int(hb.get("leader", p)) != self.leader and \
                    term >= self.index.term:
                self._repoint_to(int(hb.get("leader", p)), term,
                                 reason="heartbeat")
            if p == self.leader:
                self._last_heartbeat = time.monotonic()

    def _send_fence(self, stale: int) -> None:
        """Tell a stale-term sender it is deposed: the current term, its
        boundary sequence (the divergence the deposed node truncates
        from) and who leads now."""
        self.fences_sent += 1
        if obs.enabled():
            obs.inc("election_fences_sent_total")
        self._put(stale, TAG_FENCE,
                  {"term": self.index.term,
                   "term_start": self.index._term_start,
                   "leader": self.leader if self.role != "leader"
                   else self.rank})

    # -- the leader's watch --------------------------------------------

    def _leader_tick(self) -> None:
        self.broadcast_heartbeat()
        # a rejoining stale leader heartbeats at a lower term: fence it
        # and take it back into the shipping and catch-up set so it can
        # heal. A higher-term pulse means this node is the deposed one
        for p in self.peers:
            beats = self._drain(p, TAG_HEARTBEAT)
            if not beats:
                continue
            hb = beats[-1]
            term = int(hb["term"])
            if term < self.index.term:
                self._send_fence(p)
                if p not in self.shipper.followers:
                    self.shipper.followers.append(p)
                    trace.record_event("election.readmit", rank=p)
            elif term > self.index.term:
                self._demote(term, int(hb.get("term_start", 0)),
                             int(hb.get("leader", p)))
                return
            elif int(hb.get("leader", -1)) == p and p < self.rank:
                # a rival leader at the same term: possible only when
                # ballots diverged between election retries. Settle it
                # as the ballot does: the lowest rank keeps the term,
                # this node demotes and heals
                trace.record_event("election.split_brain",
                                   rank=self.rank, rival=p, term=term)
                self._demote(term, int(hb.get("term_start", 0)), p)
                return
        for frames in (self._drain(p, TAG_FENCE) for p in self.peers):
            for f in frames:
                if int(f["term"]) > self.index.term:
                    self._demote(int(f["term"]),
                                 int(f["term_start"]),
                                 int(f["leader"]))
                    return
        # drop queued candidacies: the pulse is the answer, and an old
        # high-round ballot must not leak into a later election
        for p in self.peers:
            self._drain(p, TAG_BALLOT)

    # -- the follower's watch ------------------------------------------

    def _leader_silent(self) -> bool:
        if time.monotonic() - self._last_heartbeat \
                > self.election_timeout:
            return True
        failed = getattr(self.mailbox, "peer_failed", None)
        return bool(failed and failed(self.leader))

    def _follower_tick(self) -> None:
        # judge silence right after folding the fresh heartbeats: a
        # drain first would age the pulse timer by the apply's time and
        # start an election against a live leader
        self._observe_heartbeats()
        if self._leader_silent():
            try:
                self.run_election()
            except (ElectionError, CommsError) as exc:
                # the survivors are unsettled (a peer mid-apply, cut
                # off, or late to see the silence): a failed election
                # must not end the watch. Back off one timeout
                trace.record_event("election.deferred", rank=self.rank,
                                   error=str(exc))
                self._last_heartbeat = time.monotonic()
            return
        # answer ballots while settled too: a candidate that saw the
        # silence first must not wait for this node's vote until it
        # times out
        for p in self.peers:
            for b in self._drain(p, TAG_BALLOT):
                self._put(p, TAG_BALLOT,
                          {"round": int(b.get("round", 0)),
                           "term": self.index.term,
                           "applied": self.index.applied_seq,
                           "rank": self.rank})
        if self.follower is not None:
            try:
                self.follower.drain()
            except TermFencedError as exc:
                # a stale leader's record reached the live channel: it
                # is rejected already; tell its sender
                self.last_fence = exc
                self._send_fence(self.follower.leader)

    # -- the election --------------------------------------------------

    def _survivors(self, exclude: int) -> Tuple[int, ...]:
        """The live ranks without the one whose silence started this
        (the failure detector may lag the timeout). From
        ``agree_on_survivors`` when a comms view is wired."""
        if self.comms is not None:
            live = self.comms.agree_on_survivors()
        else:
            failed = self.mailbox.failed_peers() \
                if hasattr(self.mailbox, "failed_peers") else {}
            live = [r for r in self.fleet if r not in failed]
        return tuple(r for r in live if r != exclude)

    def _ballot_exchange(self, survivors: Tuple[int, ...], round_: int
                         ) -> Optional[Dict[int, Tuple[int, int]]]:
        """All-to-all ``(term, applied)`` exchange among the survivors;
        None when a peer died during it (the caller tries again with a
        fresh survivor set). Ballots carry their round; those of an
        earlier election are drained and ignored."""
        votes: Dict[int, Tuple[int, int]] = {
            self.rank: (self.index.term, self.index.applied_seq)}
        frame = {"round": round_, "term": votes[self.rank][0],
                 "applied": votes[self.rank][1], "rank": self.rank}
        others = [s for s in survivors if s != self.rank]
        for p in others:
            self._put(p, TAG_BALLOT, frame)
        deadline = time.monotonic() + max(self.election_timeout, 0.5)
        for p in others:
            got = None
            while got is None:
                for b in self._drain(p, TAG_BALLOT):
                    if int(b.get("round", -1)) >= round_:
                        got = b
                if got is not None:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    trace.record_event("election.ballot_timeout",
                                       rank=self.rank, peer=p)
                    return None
                try:
                    payload = self.mailbox.get(
                        p, self.rank, TAG_BALLOT,
                        timeout=min(remaining, 0.25))
                except (CommsTimeoutError, PeerFailedError):
                    continue
                try:
                    b = decode_frame(payload)
                except WalFrameError:
                    continue
                if int(b.get("round", -1)) >= round_:
                    got = b
            votes[p] = (int(got["term"]), int(got["applied"]))
        return votes

    def run_election(self) -> ElectionRecord:
        """Elect and switch roles. Every survivor computes the same
        winner (the highest ``(term, applied_seq)``, the lowest rank on
        an exact tie) and the same new term, ``max(terms) + 1``. A
        participant lost during the exchange starts a bounded retry
        with fresh survivors; fewer survivors than a majority of the
        fleet never elect."""
        t0 = time.monotonic()
        old_leader = self.leader
        self.elections += 1
        round_ = self.elections
        attempts = 0
        quorum = len(self.fleet) // 2 + 1
        for attempts in range(1, 6):
            survivors = self._survivors(exclude=old_leader)
            if self.rank not in survivors:
                raise ElectionError(
                    f"rank {self.rank}: not in survivor clique "
                    f"{survivors}")
            if len(survivors) < quorum:
                # a minority never elects: a follower that only lost the
                # pulse for one timeout (a stall, a partition) would
                # otherwise crown itself on its own vote
                raise ElectionError(
                    f"rank {self.rank}: survivors {survivors} below "
                    f"quorum {quorum} of fleet {self.fleet} — "
                    f"refusing a minority election")
            votes = self._ballot_exchange(survivors, round_)
            if votes is not None:
                break
            trace.record_event("election.retry", rank=self.rank,
                               attempt=attempts)
        else:
            raise ElectionError(
                f"rank {self.rank}: no stable survivor clique after "
                f"{attempts} attempts")
        winner = max(votes, key=lambda r: (votes[r][0], votes[r][1],
                                           -r))
        new_term = max(t for t, _ in votes.values()) + 1
        promoted = winner == self.rank
        if promoted:
            self._promote(new_term, survivors)
        else:
            # the winner's KIND_TERM record lands at its applied horizon
            # + 1, so every loser sets the term boundary now: the fence
            # is armed while the old-term records below it still replay
            self._repoint_to(winner, new_term,
                             term_start=votes[winner][1] + 1,
                             reason="election")
        dt = time.monotonic() - t0
        rec = ElectionRecord(winner=winner, term=new_term,
                             round=round_, survivors=survivors,
                             votes=votes, seconds=dt,
                             promoted=promoted, attempts=attempts)
        self.last_election = rec
        if obs.enabled():
            obs.inc("elections_total",
                    outcome="promoted" if promoted else "repointed")
            obs.observe("election_seconds", dt)
            obs.set_gauge("fleet_term", new_term)
        trace.record_event("election.decided", rank=self.rank,
                           winner=winner, term=new_term,
                           survivors=survivors,
                           seconds=round(dt, 4), promoted=promoted)
        return rec

    # -- role transitions ---------------------------------------------

    def _promote(self, new_term: int, survivors: Tuple[int, ...]
                 ) -> None:
        """The winner's path: the index this node serves is the most
        caught-up mirror, so promotion attaches a shipper and journals
        the term boundary. No data moves, and the serving programs stay
        as they are."""
        with self._lock:
            self.role = "leader"
            self.leader = self.rank
            self.follower = None
            self.shipper = WalShipper(
                self.index, self.mailbox, self.rank,
                [s for s in survivors if s != self.rank],
                acks=self.acks, ack_timeout=self.ack_timeout)
            self.shipper.attach()
            # the new term's first durable record: it takes the next seq
            # and ships through the hook just attached, so every
            # follower's journal records the boundary
            self.index.begin_term(new_term)
            self.shipper.start()
            self.promotions += 1
        self.broadcast_heartbeat()
        if obs.enabled():
            obs.inc("election_promotions_total")
        trace.record_event("election.promoted", rank=self.rank,
                           term=new_term, followers=self.shipper.followers)
        if self.on_promote is not None:
            self.on_promote(self)

    def _repoint_to(self, winner: int, new_term: int, *,
                    term_start: Optional[int] = None,
                    reason: str) -> None:
        """The loser's path: adopt the term (and its boundary when known:
        records below it carry older terms by right and still replay)
        and follow the winner. A cursor behind heals by itself: the next
        shipped record gaps and :meth:`WalFollower.drain` catches up."""
        with self._lock:
            self.index.adopt_term(new_term)
            if term_start is not None:
                self.index._term_start = max(self.index._term_start,
                                             int(term_start))
            self.leader = int(winner)
            if self.follower is None:
                self.follower = WalFollower(self.index, self.mailbox,
                                            self.rank, self.leader)
            else:
                self.follower.repoint(self.leader)
            self.role = "follower"
            self._last_heartbeat = time.monotonic()
        trace.record_event("election.repointed", rank=self.rank,
                           leader=self.leader, term=new_term,
                           reason=reason)
        if self.on_repoint is not None:
            self.on_repoint(self)

    def _demote(self, new_term: int, term_start: int,
                new_leader: int) -> None:
        """The deposed leader's path: record the typed fence, truncate
        the unreplicated WAL suffix from the divergence, reset the
        cursor, rejoin as a follower and heal by snapshot catch-up to
        the fleet's ``content_crc``."""
        fence = TermFencedError(stale_term=self.index.term,
                                current_term=new_term,
                                divergence=term_start)
        self.last_fence = fence
        with self._lock:
            try:
                self.shipper.stop()
            except StreamingError as exc:
                trace.record_event("election.demote_shipper_error",
                                   error=str(exc))
            self.shipper.detach()
            truncated = self.index.log.truncate_from(term_start)
            # the state in memory holds the truncated suffix: force a
            # whole snapshot resync (cursor -1: the new leader ships its
            # epoch entries)
            with self.index._lock:
                self.index._applied_seq = -1
            self.index.adopt_term(new_term)
            self.index._term_start = int(term_start)
            self.role = "follower"
            self.leader = int(new_leader)
            self.follower = WalFollower(self.index, self.mailbox,
                                        self.rank, self.leader)
            self.demotions += 1
            self._last_heartbeat = time.monotonic()
        if obs.enabled():
            obs.inc("election_demotions_total")
        trace.record_event("election.demoted", rank=self.rank,
                           term=new_term, divergence=term_start,
                           truncated=truncated, leader=new_leader)
        rpt = self.follower.catch_up(timeout=self.ack_timeout)
        trace.record_event("election.demote_healed",
                           snapshot=rpt.snapshot,
                           through_seq=rpt.through_seq)
        if self.on_demote is not None:
            self.on_demote(self)

    # -- worker --------------------------------------------------------

    def tick(self) -> None:
        """One watch cycle (public for deterministic tests)."""
        if self.role == "leader":
            self._leader_tick()
        else:
            self._follower_tick()

    def _run(self) -> None:
        interval = min(self.heartbeat_interval, self.poll_interval) \
            if self.role == "leader" else self.poll_interval
        while not self._stop.wait(interval):
            try:
                self.tick()
            except (CommsAbortedError, CommsError, StreamingError,
                    Exception) as exc:  # noqa: BLE001 — raised at stop
                self._error = exc
                obs.record_failure(exc)
                trace.record_event("election.node_error",
                                   rank=self.rank, error=repr(exc))
                return

    def start(self) -> "ElectionNode":
        if self._thread is not None:
            raise StreamingError("election node already started")
        if self.role == "leader" and self.shipper is not None and \
                self.shipper._thread is None:
            self.shipper.attach()
            self.shipper.start()
        self._last_heartbeat = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"raft-tpu-election-{self.rank}")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the worker (and the shipper, when leading) and raise any
        failure the worker died on."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        if self.shipper is not None and self.role == "leader":
            self.shipper.stop()
            self.shipper.detach()
        if self._error is not None:
            err, self._error = self._error, None
            raise StreamingError("election node failed") from err

    def __enter__(self) -> "ElectionNode":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
