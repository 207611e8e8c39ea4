"""The port's leader failover (``raft_tpu_torch.neighbors.election``) and
quorum-acked WAL shipping against the reference's
``raft_tpu.neighbors.election`` on the CPU: ``tests/test_failover.py``'s
``TestElection``, ``TestFencing``, ``TestQuorumAcks``, ``TestFrameFuzz``,
the shipper case of ``TestOnAppendSubscribers``, the two failover knobs
of ``TestEnvKnobs``, ``TestServeFailover`` and ``TestFailoverChaos``
(the journal-only cases are in ``tests/test_torch_streaming.py``), then
the two packages' elections on the same fleet states and their frames.

The in-process fleets drive ``run_election()`` and ``tick()`` by hand,
as the reference's tests do; only the shippers' pollers run, because a
catch-up needs a live responder. Where both packages build an index they
share the data and the reference's trained centroids, so their journals
and ballots are the same.

Tolerances: all exact (``ElectionRecord`` fields, ``content_crc()``,
cursors, terms, frame bytes).

The replica cases serve brute-force kNN, as ``tests/test_torch_replica.py``
does. The three-process SIGKILL witness spawns
``tests/_torch_failover_worker.py`` (no jax; 110 s a process) and is
marked slow, as the reference's.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from raft_tpu.comms.comms import _Mailbox as RBox
from raft_tpu.neighbors import election as jel
from raft_tpu.neighbors import streaming as jst
from raft_tpu.neighbors import wal_ship as jws
from raft_tpu_torch import device_resources, obs
from raft_tpu_torch.comms.comms import MeshComms, _Mailbox
from raft_tpu_torch.core import env
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.neighbors.election import (TAG_FENCE, TAG_HEARTBEAT,
                                               ElectionError, ElectionNode)
from raft_tpu_torch.neighbors.streaming import (MutationLog, StreamingError,
                                                StreamingIndex,
                                                TermFencedError,
                                                _coarse_assign, stream_build)
from raft_tpu_torch.neighbors.wal_ship import (FRAME_END, FRAME_SNAPSHOT,
                                               FRAME_WAL, TAG_WAL,
                                               WalFollower, WalFrameError,
                                               WalQuorumError, WalShipper,
                                               bootstrap_follower,
                                               decode_frame, encode_frame,
                                               frame_kind)
from raft_tpu_torch.obs import metrics as obs_metrics
from raft_tpu_torch.serve.ingest import (IngestController, NotLeaderError,
                                         StreamingKnnService)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = device_resources("cpu")

N, D, L = 160, 8, 8


def _mk_leader(tmp_path, seed=3, name="n0"):
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(N, D)).astype(np.float32)
    idx = stream_build(CPU, db, L, seed=0, max_iter=4,
                       directory=str(tmp_path / name))
    return idx, rng


def _rows(rng, m=6):
    return rng.normal(size=(m, D)).astype(np.float32)


@pytest.fixture
def live_obs():
    """Metrics on with a private registry."""
    was_enabled = obs.enabled()
    old_reg = obs_metrics.set_registry(obs.MetricsRegistry())
    obs.set_enabled(True)
    try:
        yield obs_metrics.get_registry()
    finally:
        obs.set_enabled(was_enabled)
        obs_metrics.set_registry(old_reg)


def _counter(reg, name):
    fam = reg.snapshot().get(name)
    if not fam:
        return 0.0
    return sum(s["value"] for s in fam["series"])


def _stop(sh):
    if sh._thread is not None:
        sh.stop()
    sh.detach()


def _teardown(*nodes):
    for n in nodes:
        if n.role == "leader" and n.shipper is not None:
            _stop(n.shipper)


def _elect(*nodes):
    """The all-to-all election, run by every survivor at once (each one's
    ballot exchange needs the others' answers)."""
    recs, errs = {}, {}

    def run(n):
        try:
            recs[n.rank] = n.run_election()
        except BaseException as exc:  # noqa: BLE001 — re-raised
            errs[n.rank] = exc

    threads = [threading.Thread(target=run, args=(n,)) for n in nodes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert not errs, errs
    return recs


# ---------------------------------------------------------------------------
# the election: promotion of the most caught-up survivor
# ---------------------------------------------------------------------------


def _trio(tmp_path, *, catch_up=(1, 2), mbx=None, comms=False):
    idx0, rng = _mk_leader(tmp_path)
    mbx = _Mailbox() if mbx is None else mbx
    kw = dict(acks="async", election_timeout=2.0, ack_timeout=30.0)
    views = {}
    if comms:
        mbx.size = 3
        views = {r: MeshComms(None, rank=r, _mailbox=mbx)
                 for r in range(3)}
    n0 = ElectionNode(idx0, mbx, 0, [0, 1, 2], role="leader", leader=0,
                      heartbeat_interval=0.05, comms=views.get(0), **kw)
    n0.shipper.attach()
    n0.shipper.start()
    nodes = {0: n0}
    for r in (1, 2):
        fidx = bootstrap_follower(CPU, dim=D, n_lists=L,
                                  directory=str(tmp_path / f"n{r}"))
        wf = WalFollower(fidx, mbx, r, 0)
        if r in catch_up:
            wf.catch_up(timeout=60.0)
        nodes[r] = ElectionNode(fidx, mbx, r, [0, 1, 2], role="follower",
                                leader=0, follower=wf, comms=views.get(r),
                                **kw)
    return idx0, rng, mbx, nodes[0], nodes[1], nodes[2]


class TestElection:
    def test_most_caught_up_follower_wins(self, tmp_path):
        idx0, rng, mbx, n0, n1, n2 = _trio(tmp_path)
        try:
            for _ in range(2):
                idx0.insert(_rows(rng))
            n1.follower.drain()
            n2.follower.drain()
            for _ in range(2):
                idx0.insert(_rows(rng))
            n1.follower.drain()                 # rank 1 pulls ahead
            assert n1.index.applied_seq > n2.index.applied_seq
            horizon = n1.index.applied_seq

            _stop(n0.shipper)
            mbx.fail_peer(0, "killed")
            recs = _elect(n1, n2)

            # every survivor decided the same election
            assert recs[1].winner == recs[2].winner == 1
            assert recs[1].term == recs[2].term == 1
            assert recs[1].votes == recs[2].votes
            assert recs[1].promoted and not recs[2].promoted
            assert n1.role == "leader" and n1.leader == 1
            assert n2.role == "follower" and n2.leader == 1
            # the loser armed its fence at the winner's horizon + 1,
            # where KIND_TERM lands
            assert n2.index._term_start == horizon + 1
            assert n2.index.term == 1

            # the lagging loser heals from the new leader and writes go
            # on: equal content, no row lost
            n1.index.insert(_rows(rng))
            n2.follower.drain()
            assert n2.index.applied_seq == n1.index.applied_seq
            assert n2.index.content_crc() == n1.index.content_crc()
        finally:
            _teardown(n0, n1, n2)

    def test_equal_applied_rank_tiebreak(self, tmp_path):
        """Identical ``(term, applied_seq)`` ballots: the lowest
        surviving rank wins, on every survivor."""
        idx0, rng, mbx, n0, n1, n2 = _trio(tmp_path)
        try:
            idx0.insert(_rows(rng))
            n1.follower.drain()
            n2.follower.drain()
            assert n1.index.applied_seq == n2.index.applied_seq
            _stop(n0.shipper)
            mbx.fail_peer(0, "killed")
            recs = _elect(n1, n2)
            assert recs[1].votes[1] == recs[1].votes[2]
            assert recs[1].winner == recs[2].winner == 1
            assert n1.role == "leader" and n2.leader == 1
        finally:
            _teardown(n0, n1, n2)

    def test_minority_clique_refuses_election(self, tmp_path):
        """One survivor of three never crowns itself: the election
        raises, the node stays a follower and the term stays."""
        idx0, rng, mbx, n0, n1, n2 = _trio(tmp_path)
        try:
            mbx.fail_peer(0, "killed")
            mbx.fail_peer(2, "killed")
            with pytest.raises(ElectionError, match="quorum"):
                n1.run_election()
            assert n1.role == "follower"
            assert n1.index.term == 0
        finally:
            _teardown(n0, n1, n2)

    def test_election_during_inflight_catchup(self, tmp_path):
        """A follower whose bootstrap catch-up never completed when the
        leader died: its ballot loses, and it heals from the new
        leader's snapshot afterwards."""
        idx0, rng, mbx, n0, n1, n2 = _trio(tmp_path, catch_up=(1,))
        try:
            idx0.insert(_rows(rng))
            n1.follower.drain()
            assert n2.index.applied_seq < n1.index.applied_seq
            _stop(n0.shipper)
            mbx.fail_peer(0, "killed")
            recs = _elect(n1, n2)
            assert recs[2].winner == 1 and not recs[2].promoted
            n2.follower.catch_up(timeout=60.0)
            assert n2.index.term == 1
            assert n2.index.content_crc() == n1.index.content_crc()
        finally:
            _teardown(n0, n1, n2)

    def test_deposed_leader_truncates_and_heals(self, tmp_path):
        """The rejoin, end to end: the old leader appends a suffix the
        quorum never saw, hears the new term, records the typed fence,
        truncates from the divergence, demotes and converges."""
        idx0, rng, mbx, n0, n1, n2 = _trio(tmp_path)
        try:
            idx0.insert(_rows(rng))
            n1.follower.drain()
            n2.follower.drain()
            divergence = idx0.applied_seq + 1   # first unshipped seq

            recs = _elect(n1, n2)               # the old leader is silent
            assert recs[1].promoted
            n2.follower.drain()

            # the deposed leader, unaware, appends two records
            idx0.insert(_rows(rng, 4))
            idx0.insert(_rows(rng, 3))
            stale_applied = idx0.applied_seq
            assert stale_applied >= divergence

            # the deposed leader pulses its old term first, so the new
            # leader takes it back into its shipping set; then its own
            # tick hears term 1 and demotes
            n0.broadcast_heartbeat()
            n1.tick()
            assert 0 in n1.shipper.followers
            assert n1.fences_sent >= 1
            n0.tick()
            assert n0.role == "follower" and n0.leader == 1
            fence = n0.last_fence
            assert isinstance(fence, TermFencedError)
            assert fence.stale_term == 0 and fence.current_term == 1
            assert fence.divergence == divergence
            # the suffix is gone from journal and content
            assert n0.index.applied_seq == n1.index.applied_seq
            assert n0.index.content_crc() == n1.index.content_crc()
            assert n0.index.term == 1
            assert all(int(r["seq"]) <= n1.index.applied_seq
                       for r in n0.index.log.wal_records())

            n1.index.insert(_rows(rng))
            n0.follower.drain()
            n2.follower.drain()
            assert n0.index.content_crc() == n1.index.content_crc() \
                == n2.index.content_crc()
        finally:
            _teardown(n0, n1, n2)

    def test_comms_survivors_elect_the_same(self, tmp_path):
        """With a comms view wired, the survivors come from
        ``MeshComms.agree_on_survivors`` (the shared failure detector of
        the in-process mailbox): the same election, and a minority still
        refuses."""
        idx0, rng, mbx, n0, n1, n2 = _trio(tmp_path, comms=True)
        try:
            idx0.insert(_rows(rng))
            n1.follower.drain()
            _stop(n0.shipper)
            mbx.fail_peer(0, "killed")
            assert n1._survivors(exclude=0) == (1, 2)
            recs = _elect(n1, n2)
            assert recs[1].winner == recs[2].winner == 1
            assert recs[1].survivors == recs[2].survivors == (1, 2)
            mbx.fail_peer(1, "killed")
            with pytest.raises(ElectionError, match="quorum"):
                ElectionNode(n2.index, mbx, 2, [0, 1, 2],
                             role="follower", leader=1,
                             comms=n2.comms).run_election()
        finally:
            _teardown(n0, n1, n2)

    def test_threaded_nodes_elect_on_silence(self, tmp_path):
        """The worker threads: the followers hear the leader's pulse,
        then its silence, and elect by themselves; ``stop`` raises no
        worker error."""
        idx0, rng, mbx, n0, n1, n2 = _trio(tmp_path)
        for n in (n1, n2):
            n.election_timeout = 0.5
        try:
            for n in (n0, n1, n2):
                n.start()
            idx0.insert(_rows(rng))
            deadline = time.monotonic() + 10.0
            while min(n1.index.applied_seq, n2.index.applied_seq) < \
                    idx0.applied_seq:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            n0.stop()                           # the pulse stops
            mbx.fail_peer(0, "killed")
            deadline = time.monotonic() + 20.0
            while not any(n.role == "leader" for n in (n1, n2)):
                assert time.monotonic() < deadline, (n1._error, n2._error)
                time.sleep(0.01)
            winner = n1 if n1.role == "leader" else n2
            other = n2 if winner is n1 else n1
            while other.leader != winner.rank:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            winner.index.insert(_rows(rng))
            while other.index.applied_seq < winner.index.applied_seq:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            assert other.index.content_crc() == winner.index.content_crc()
        finally:
            for n in (n1, n2):
                n.stop()

    def test_node_validation_and_worker_error(self, tmp_path, monkeypatch):
        idx0, rng = _mk_leader(tmp_path)
        mbx = _Mailbox()
        with pytest.raises(ValueError, match="leader|follower"):
            ElectionNode(idx0, mbx, 0, [0, 1], role="boss", leader=0)
        with pytest.raises(ValueError, match="not in fleet"):
            ElectionNode(idx0, mbx, 5, [0, 1], role="leader", leader=5)
        bare = stream_build(CPU, _rows(rng, 64), 4, seed=0, max_iter=2)
        with pytest.raises(StreamingError, match="journaled"):
            ElectionNode(bare, mbx, 0, [0, 1], role="leader", leader=0)
        node = ElectionNode(idx0, mbx, 0, [0, 1], role="leader", leader=0,
                            acks="async", election_timeout=0.2)
        assert node.heartbeat_interval == pytest.approx(0.05)

        def boom():
            raise RuntimeError("tick broke")

        monkeypatch.setattr(node, "tick", boom)
        node.start()
        with pytest.raises(StreamingError, match="already started"):
            node.start()
        node._thread.join(timeout=10.0)
        with pytest.raises(StreamingError, match="election node failed"):
            node.stop()


# ---------------------------------------------------------------------------
# term fencing at the record level
# ---------------------------------------------------------------------------


class TestFencing:
    def _pair(self, tmp_path):
        idx0, rng = _mk_leader(tmp_path)
        mbx = _Mailbox()
        sh = WalShipper(idx0, mbx, 0, [1], poll_interval=0.01).attach()
        sh.start()
        fidx = bootstrap_follower(CPU, dim=D, n_lists=L,
                                  directory=str(tmp_path / "n1"))
        wf = WalFollower(fidx, mbx, 1, 0)
        wf.catch_up(timeout=60.0)
        return idx0, rng, mbx, sh, fidx, wf

    def test_stale_record_raises_typed_fence(self, tmp_path):
        idx0, rng, mbx, sh, fidx, wf = self._pair(tmp_path)
        try:
            idx0.insert(_rows(rng))
            wf.drain()
            boundary = fidx.applied_seq + 1
            fidx.adopt_term(3)
            fidx._term_start = boundary
            idx0.insert(_rows(rng))             # still stamped term 0
            with pytest.raises(TermFencedError) as ei:
                wf.drain()
            assert ei.value.stale_term == 0
            assert ei.value.current_term == 3
            assert ei.value.divergence == boundary
            assert fidx.applied_seq == boundary - 1   # never applied
            assert wf.fenced == 1
        finally:
            _stop(sh)

    def test_records_below_boundary_still_replay(self, tmp_path):
        """The fence is ``term < cur and seq >= boundary``: old-term
        records below the boundary are history and still replay after a
        term adoption."""
        idx0, rng, mbx, sh, fidx, wf = self._pair(tmp_path)
        try:
            idx0.insert(_rows(rng))             # seq s, term 0
            fidx.adopt_term(2)
            fidx._term_start = idx0.applied_seq + 1
            wf.drain()                          # applies, no fence
            assert fidx.applied_seq == idx0.applied_seq
            assert fidx.content_crc() == idx0.content_crc()
            idx0.insert(_rows(rng))             # seq >= boundary: fenced
            with pytest.raises(TermFencedError):
                wf.drain()
        finally:
            _stop(sh)

    def test_follower_tick_sends_fence_nack(self, tmp_path):
        """A stale record on a node's live channel is rejected and its
        sender gets a TAG_FENCE frame with the current term and
        boundary."""
        idx0, rng, mbx, sh, fidx, wf = self._pair(tmp_path)
        try:
            node = ElectionNode(fidx, mbx, 1, [0, 1, 2], role="follower",
                                leader=0, follower=wf, acks="async",
                                election_timeout=60.0)
            fidx.adopt_term(1)
            fidx._term_start = fidx.applied_seq + 1
            idx0.insert(_rows(rng))
            node.tick()
            assert isinstance(node.last_fence, TermFencedError)
            fence = decode_frame(mbx.get_nowait(1, 0, TAG_FENCE))
            assert int(fence["term"]) == 1
            assert int(fence["term_start"]) == fidx._term_start
        finally:
            _stop(sh)


# ---------------------------------------------------------------------------
# quorum-acked writes
# ---------------------------------------------------------------------------


class TestQuorumAcks:
    def _fleet(self, tmp_path, *, acks="majority", ack_timeout=30.0):
        idx0, rng = _mk_leader(tmp_path)
        mbx = _Mailbox()
        sh = WalShipper(idx0, mbx, 0, [1, 2], acks=acks,
                        ack_timeout=ack_timeout,
                        poll_interval=0.01).attach()
        sh.start()
        wfs = []
        for r in (1, 2):
            fidx = bootstrap_follower(CPU, dim=D, n_lists=L,
                                      directory=str(tmp_path / f"n{r}"))
            wf = WalFollower(fidx, mbx, r, 0)
            wf.catch_up(timeout=60.0)
            wfs.append(wf)
        return idx0, rng, mbx, sh, wfs

    @staticmethod
    def _pump(wf, stop):
        while not stop.is_set():
            wf.drain()
            time.sleep(0.005)

    def _pumps(self, wfs):
        stop = threading.Event()
        threads = [threading.Thread(target=self._pump, args=(wf, stop),
                                    daemon=True) for wf in wfs]
        for t in threads:
            t.start()
        return stop, threads

    def test_acks_needed_ladder(self, tmp_path):
        idx0, rng = _mk_leader(tmp_path)
        mbx = _Mailbox()

        def mk(a):
            return WalShipper(idx0, mbx, 0, [1, 2], acks=a)

        assert mk("async").acks_needed() == 0
        assert mk("majority").acks_needed() == 1   # ceil((3+1)/2) - 1
        assert mk("all").acks_needed() == 2
        assert mk(2).acks_needed() == 2
        assert mk(5).acks_needed() == 2            # at most the fleet
        r = jws.WalShipper.acks_needed
        for a in ("async", "majority", "all", 1, 2, 5):
            for fl in ([1], [1, 2], [1, 2, 3, 4]):
                s = WalShipper(idx0, mbx, 0, fl, acks=a)
                assert s.acks_needed() == r(s)

    def test_majority_blocks_until_follower_confirms(self, tmp_path):
        idx0, rng, mbx, sh, (wf1, wf2) = self._fleet(tmp_path)
        stop, threads = self._pumps([wf1])
        try:
            # one live follower makes a majority; wf2 stays idle
            idx0.insert(_rows(rng))
            assert sh.quorum_waits == 1
            assert sh.acked_seq(1) >= idx0.applied_seq
            assert wf1.index.applied_seq == idx0.applied_seq
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10.0)
            _stop(sh)

    def test_quorum_timeout_typed_indeterminate(self, tmp_path, live_obs):
        idx0, rng, mbx, sh, wfs = self._fleet(tmp_path, acks="all",
                                              ack_timeout=0.5)
        try:
            before = idx0.applied_seq
            with pytest.raises(WalQuorumError) as ei:
                idx0.insert(_rows(rng))
            assert ei.value.acked == 0 and ei.value.needed == 2
            assert ei.value.seq == before + 1
            # indeterminate, not rolled back: durable here, the caller
            # retries with the same write_id
            assert idx0.applied_seq == before + 1
            assert "retry idempotently" in str(ei.value)
            assert str(ei.value) == str(jws.WalQuorumError(
                seq=before + 1, acked=0, needed=2))
            assert _counter(live_obs, "wal_quorum_timeouts_total") == 1
        finally:
            _stop(sh)

    def test_replication_lag_gauge(self, tmp_path, live_obs):
        idx0, rng, mbx, sh, wfs = self._fleet(tmp_path)
        stop, threads = self._pumps(wfs)
        try:
            idx0.insert(_rows(rng))
            deadline = time.monotonic() + 10.0
            fam = None
            while time.monotonic() < deadline:
                sh.drain_acks()
                fam = live_obs.snapshot().get(
                    "wal_replication_lag_seconds")
                if fam and len(fam["series"]) >= 1:
                    break
                time.sleep(0.01)
            assert fam, "lag gauge never exported"
            assert all(s["labels"].get("follower") in ("1", "2")
                       for s in fam["series"])
            assert all(s["value"] >= 0.0 for s in fam["series"])
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10.0)
            _stop(sh)

    def test_write_id_replay_idempotent_and_replicated(self, tmp_path):
        idx0, rng, mbx, sh, (wf1, wf2) = self._fleet(tmp_path)
        stop, threads = self._pumps([wf1, wf2])
        try:
            ids_a = idx0.insert(_rows(rng, 2), write_id=77)
            seq = idx0.applied_seq
            ids_b = idx0.insert(_rows(rng, 2), write_id=77)
            assert np.array_equal(ids_a, ids_b)
            assert idx0.applied_seq == seq      # no second record
            deadline = time.monotonic() + 10.0
            while wf1.index.applied_seq < seq and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            assert np.array_equal(wf1.index.seen_write_id(77), ids_a)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10.0)
            _stop(sh)


# ---------------------------------------------------------------------------
# frame integrity
# ---------------------------------------------------------------------------


class TestFrameFuzz:
    REC = {"_frame": FRAME_WAL, "kind": 1, "seq": 4,
           "rows": np.arange(12, dtype=np.float32).reshape(3, 4)}

    def test_roundtrip(self):
        out = decode_frame(encode_frame(self.REC))
        assert frame_kind(out) == FRAME_WAL
        assert int(out["seq"]) == 4
        np.testing.assert_array_equal(out["rows"], self.REC["rows"])

    def test_bytes_equal_the_reference(self):
        """The same entries encode to the same bytes in both packages,
        and each decodes the other's."""
        recs = [self.REC, {"_frame": FRAME_END, "through_seq": 17},
                {"from_seq": -3}, {"applied": 5, "rank": 2, "term": 1}]
        for rec in recs:
            mine, theirs = encode_frame(rec), jws.encode_frame(rec)
            assert mine.dtype == theirs.dtype == np.uint8
            assert mine.tobytes() == theirs.tobytes()
            for k, v in jws.decode_frame(mine).items():
                np.testing.assert_array_equal(v, rec[k])
            assert decode_frame(theirs).keys() == rec.keys()

    def test_bit_flip_fuzz(self):
        """Single-bit damage anywhere in the container raises the typed
        WalFrameError or decodes with every value intact (payloads are
        CRC-covered; a flip in an entry name only renames a key), never
        a silently wrong value or an untyped error. The reference sees
        the same flips the same way."""
        payload = encode_frame(self.REC)
        rng = np.random.default_rng(0)
        detected = 0
        for _ in range(64):
            bad = payload.copy()
            pos = int(rng.integers(len(bad)))
            bad[pos] ^= np.uint8(1 << int(rng.integers(8)))
            try:
                out = decode_frame(bad)
            except WalFrameError:
                detected += 1
                with pytest.raises(jws.WalFrameError):
                    jws.decode_frame(bad)
                continue
            for k, v in self.REC.items():
                if k in out:
                    np.testing.assert_array_equal(out[k], v)
        assert detected > 0

    def test_truncation_detected(self):
        payload = encode_frame(self.REC)
        for frac in (0.1, 0.5, 0.9):
            with pytest.raises(WalFrameError):
                decode_frame(payload[:int(len(payload) * frac)])
        with pytest.raises(WalFrameError):
            decode_frame(payload[:0])

    def test_wrong_frame_tag(self):
        with pytest.raises(WalFrameError, match="unknown"):
            frame_kind({"_frame": 99})
        with pytest.raises(WalFrameError, match="_frame"):
            frame_kind({"seq": 1})
        with pytest.raises(WalFrameError, match="encode"):
            encode_frame({"x": object()})

    def test_wrong_kind_on_wal_channel(self, tmp_path):
        """A snapshot frame put on the live TAG_WAL channel is rejected,
        typed, not applied."""
        idx0, rng = _mk_leader(tmp_path)
        mbx = _Mailbox()
        sh = WalShipper(idx0, mbx, 0, [1], poll_interval=0.01).attach()
        sh.start()
        fidx = bootstrap_follower(CPU, dim=D, n_lists=L,
                                  directory=str(tmp_path / "n1"))
        wf = WalFollower(fidx, mbx, 1, 0)
        wf.catch_up(timeout=60.0)
        try:
            mbx.put(0, 1, TAG_WAL, encode_frame({"_frame": FRAME_SNAPSHOT}))
            with pytest.raises(WalFrameError, match="FRAME_WAL"):
                wf.drain()
        finally:
            _stop(sh)


# ---------------------------------------------------------------------------
# MutationLog append fan-out with a shipper
# ---------------------------------------------------------------------------


class TestOnAppendSubscribers:
    def test_shipper_exclusive_but_observers_coexist(self, tmp_path):
        """One shipper a journal (two would ship every record twice),
        but plain observers ride along."""
        idx0, rng = _mk_leader(tmp_path)
        mbx = _Mailbox()
        seen = []
        idx0.log.add_on_append(lambda rec: seen.append(int(rec["seq"])))
        sh = WalShipper(idx0, mbx, 0, [1]).attach()
        assert sh.attach() is sh                # the same instance: ok
        with pytest.raises(StreamingError, match="on_append"):
            WalShipper(idx0, mbx, 0, [2]).attach()
        idx0.insert(_rows(rng))
        assert seen                             # the observer fired
        assert mbx.get_nowait(0, 1, TAG_WAL) is not None
        sh.detach()
        WalShipper(idx0, mbx, 0, [2]).attach().detach()

    def test_detached_shipper_ships_nothing(self, tmp_path):
        """``detach`` unsubscribes the shipper's hook (a bound method,
        found by equality), so a detached shipper sends no record and a
        second shipper may attach."""
        idx0, rng = _mk_leader(tmp_path)
        mbx = _Mailbox()
        sh = WalShipper(idx0, mbx, 0, [1]).attach()
        sh.detach()
        assert idx0.log.on_append is None
        idx0.insert(_rows(rng))
        assert mbx.get_nowait(0, 1, TAG_WAL) is None
        assert sh.shipped == 0
        sh2 = WalShipper(idx0, mbx, 0, [2]).attach()
        idx0.insert(_rows(rng))
        assert mbx.get_nowait(0, 2, TAG_WAL) is not None
        assert mbx.get_nowait(0, 1, TAG_WAL) is None
        sh2.detach()

    def test_detached_quorum_shipper_holds_no_write(self, tmp_path):
        """A quorum shipper's ``detach`` removes the commit barrier it
        installed: a write after it returns without waiting for acks."""
        idx0, rng = _mk_leader(tmp_path)
        sh = WalShipper(idx0, _Mailbox(), 0, [1, 2], acks="all",
                        ack_timeout=0.2).attach()
        assert idx0._commit_barrier is not None
        sh.detach()
        assert idx0._commit_barrier is None
        idx0.insert(_rows(rng))
        assert sh.quorum_waits == 0


# ---------------------------------------------------------------------------
# the failover knobs: fail loud, at import
# ---------------------------------------------------------------------------


class TestEnvKnobs:
    @pytest.mark.parametrize("name,bad,good,parsed", [
        ("RAFT_TPU_ELECTION_TIMEOUT", "0", "2.5", 2.5),
        ("RAFT_TPU_ELECTION_TIMEOUT", "fast", "0.5", 0.5),
        ("RAFT_TPU_WAL_QUORUM", "0", "majority", "majority"),
        ("RAFT_TPU_WAL_QUORUM", "sometimes", "3", 3),
    ])
    def test_registered_fail_loud(self, monkeypatch, name, bad, good,
                                  parsed):
        from raft_tpu.core import env as r_env

        monkeypatch.setenv(name, bad)
        with pytest.raises(ValueError, match=name):
            env.read(name)
        with pytest.raises(ValueError, match=name):
            r_env.read(name)
        monkeypatch.setenv(name, good)
        assert env.read(name) == parsed == r_env.read(name)

    def test_defaults_and_readers(self, tmp_path, monkeypatch):
        monkeypatch.delenv("RAFT_TPU_ELECTION_TIMEOUT", raising=False)
        monkeypatch.delenv("RAFT_TPU_WAL_QUORUM", raising=False)
        assert env.read("RAFT_TPU_ELECTION_TIMEOUT") == 1.0
        assert env.read("RAFT_TPU_WAL_QUORUM") == "async"
        idx0, rng = _mk_leader(tmp_path)
        monkeypatch.setenv("RAFT_TPU_WAL_QUORUM", "all")
        monkeypatch.setenv("RAFT_TPU_ELECTION_TIMEOUT", "3.0")
        assert WalShipper(idx0, _Mailbox(), 0, [1, 2]).acks_needed() == 2
        node = ElectionNode(idx0, _Mailbox(), 0, [0, 1], role="leader",
                            leader=0)
        assert node.election_timeout == 3.0
        assert node.heartbeat_interval == 0.75
        assert node.acks == "all"

    @pytest.mark.parametrize("name,bad", [
        ("RAFT_TPU_ELECTION_TIMEOUT", "-1"),
        ("RAFT_TPU_WAL_QUORUM", "most"),
    ])
    def test_malformed_knob_fails_at_import(self, name, bad):
        """Both knobs are checked when the election module imports: a
        fleet never comes up with a wrong succession setting."""
        code = "import raft_tpu_torch.neighbors.election\n"
        env2 = dict(os.environ)
        env2[name] = bad
        env2["PYTHONPATH"] = _REPO + os.pathsep + env2.get(
            "PYTHONPATH", "")
        p = subprocess.run([sys.executable, "-c", code], env=env2,
                           capture_output=True, text=True, timeout=120)
        assert p.returncode != 0
        assert name in p.stderr


# ---------------------------------------------------------------------------
# serving tier: leader-aware ingest and routing promotion
# ---------------------------------------------------------------------------


class TestServeFailover:
    def _ctl(self, idx, election=None):
        from raft_tpu_torch.serve import BatchPolicy

        return IngestController(
            idx, [StreamingKnnService(idx, k=4, nprobe=3)],
            policy=BatchPolicy(max_batch=16, max_wait_ms=2.0),
            compact_interval=30.0, refit=False, warm_buckets=[4],
            election=election)

    def test_follower_write_redirects_typed(self, tmp_path):
        idx, rng = _mk_leader(tmp_path, name="n1")
        mbx = _Mailbox()
        node = ElectionNode(idx, mbx, 1, [0, 1], role="follower",
                            leader=0, acks="async", election_timeout=60.0)
        ctl = self._ctl(idx, election=node)
        with ctl:
            assert not ctl.is_leader() and ctl.leader == 0
            with pytest.raises(NotLeaderError) as ei:
                ctl.insert(_rows(rng))
            assert ei.value.leader == 0 and ei.value.rank == 1
            with pytest.raises(NotLeaderError):
                ctl.delete(np.array([0, 1]))
            # queries go on serving on a follower: only writes redirect
            q = _rows(rng, 4)
            svc = ctl.streaming_services[0].name
            out = ctl.submit(svc, q).result(timeout=60.0)
            assert out[0].shape == (4, 4)

    def test_promotion_rolls_the_controller(self, tmp_path):
        """A real two-survivor election behind two controllers: the
        winner's controller takes writes with no new trace, the loser's
        redirects to it, and the loser's served rows follow."""
        idx0, rng, mbx, n0, n1, n2 = _trio(tmp_path)
        ctls = {r: self._ctl(n.index, election=n)
                for r, n in ((1, n1), (2, n2))}
        try:
            for c in ctls.values():
                c.executor.warm([4])
            idx0.insert(_rows(rng))
            n1.follower.drain()
            n2.follower.drain()
            _stop(n0.shipper)
            mbx.fail_peer(0, "killed")
            refreshes = ctls[1].refreshes
            _elect(n1, n2)
            assert ctls[1].refreshes == refreshes + 1   # on_promote
            assert ctls[1].is_leader() and ctls[2].leader == 1
            traces = ctls[1].executor.stats.traces
            ids = ctls[1].insert(_rows(rng, 3), write_id=9)
            assert ctls[1].executor.stats.traces == traces
            with pytest.raises(NotLeaderError) as ei:
                ctls[2].insert(_rows(rng))
            assert ei.value.leader == 1
            n2.follower.drain()
            assert np.array_equal(n2.index.seen_write_id(9), ids)
            assert n2.index.content_crc() == n1.index.content_crc()
        finally:
            _teardown(n0, n1, n2)

    def test_leader_controller_write_id_dedup(self, tmp_path):
        idx, rng = _mk_leader(tmp_path)
        ctl = self._ctl(idx)
        with ctl:
            assert ctl.is_leader()              # no election wired
            ids_a = ctl.insert(_rows(rng, 3), write_id=5)
            seq = idx.applied_seq
            ids_b = ctl.insert(_rows(rng, 3), write_id=5)
            assert np.array_equal(ids_a, ids_b)
            assert idx.applied_seq == seq

    @staticmethod
    def _fleet(n=3):
        from raft_tpu_torch.serve import (BatchPolicy, Executor, KnnService,
                                          ReplicaGroup)

        rng = np.random.default_rng(2)
        X = torch.from_numpy(rng.standard_normal((256, 12)).astype(
            np.float32))

        def make_ex():
            ex = Executor([KnnService(X, k=4)],
                          policy=BatchPolicy(max_batch=32,
                                             max_wait_ms=1.0))
            ex.warm([8])
            return ex

        return X, ReplicaGroup([make_ex() for _ in range(n)]), "knn_k4_l2"

    def test_replica_group_promote_zero_recompiles(self, live_obs):
        X, group, op = self._fleet()
        with group:
            for _ in range(4):
                group.route(op, X[:8])[1].result(timeout=60.0)
            assert group.leader is None
            traces0 = [r.executor.stats.traces for r in group.replicas]
            rep = group.promote("replica1")
            assert group.leader is rep and rep.name == "replica1"
            # the leader marker moved, no data: the warmed programs stay
            for _ in range(4):
                group.route(op, X[:8])[1].result(timeout=60.0)
            assert [r.executor.stats.traces
                    for r in group.replicas] == traces0
            assert _counter(live_obs,
                            "serve_replica_promotions_total") == 1.0
            group.fail_replica("replica2")
            with pytest.raises(ValueError, match="promote"):
                group.promote("replica2")

    def test_chaos_kill_leader_scenario(self):
        """The write leader dies at the spike's peak, a survivor is
        promoted, and both failover clocks are stamped."""
        from raft_tpu_torch.serve.loadgen import run_chaos

        X, group, op = self._fleet()
        with group:
            rep = run_chaos("kill_leader", group, op, clients=4,
                            phase_s=1.0)
        notes = rep.notes
        assert notes["killed_leader"] == notes["old_leader"]
        assert notes["new_leader"] is not None
        assert notes["new_leader"] != notes["old_leader"]
        assert notes["time_to_new_leader_s"] is not None
        assert notes["recovery_time_to_slo_s"] is not None


# ---------------------------------------------------------------------------
# the two packages' elections on the same fleet states
# ---------------------------------------------------------------------------


def _twin_trios(tmp_path, catch_up):
    """A reference trio and a port trio over one database and the
    reference's trained centroids (byte-identical journals)."""
    db = np.random.default_rng(3).normal(size=(N, D)).astype(np.float32)
    jidx = jst.stream_build(None, db, L, seed=0, max_iter=4,
                            directory=str(tmp_path / "j0"))
    c = np.array(jidx.flat.centroids)
    flat = ivf_flat.build(CPU, torch.from_numpy(db), L,
                          centroids=torch.from_numpy(c))
    tidx = StreamingIndex(flat, log=MutationLog(str(tmp_path / "t0")),
                          res=CPU)
    dist, _ = _coarse_assign(db, flat.centroids)
    tidx.drift.set_baseline(float(np.mean(dist)))
    with tidx._lock:
        tidx._write_epoch_locked(crash=False)
    kw = dict(acks="async", election_timeout=2.0, ack_timeout=30.0)
    out = {}
    for pkg, idx0, Box, Node, Follow, boot in (
            ("ref", jidx, RBox, jel.ElectionNode, jws.WalFollower,
             lambda d: jws.bootstrap_follower(None, dim=D, n_lists=L,
                                              directory=d)),
            ("port", tidx, _Mailbox, ElectionNode, WalFollower,
             lambda d: bootstrap_follower(CPU, dim=D, n_lists=L,
                                          directory=d))):
        mbx = Box()
        n0 = Node(idx0, mbx, 0, [0, 1, 2], role="leader", leader=0,
                  heartbeat_interval=0.05, **kw)
        n0.shipper.attach()
        n0.shipper.start()
        nodes = [n0]
        for r in (1, 2):
            fidx = boot(str(tmp_path / f"{pkg}{r}"))
            wf = Follow(fidx, mbx, r, 0)
            if r in catch_up:
                wf.catch_up(timeout=60.0)
            nodes.append(Node(fidx, mbx, r, [0, 1, 2], role="follower",
                              leader=0, follower=wf, **kw))
        out[pkg] = (mbx, nodes)
    return out


@pytest.mark.parametrize("state", ["ahead", "tie", "inflight"])
def test_elections_match_the_reference(tmp_path, state):
    """The same fleet states in both packages (rank 1 ahead of rank 2,
    equal ballots, rank 2's bootstrap never finished): every field of
    every survivor's ``ElectionRecord`` but the wall time is the
    reference's, and so are the terms, boundaries and content after."""
    fleets = _twin_trios(tmp_path, (1,) if state == "inflight" else (1, 2))
    rng = {p: np.random.default_rng(4) for p in fleets}
    recs = {}
    try:
        for pkg, (mbx, (n0, n1, n2)) in fleets.items():
            n0.index.insert(_rows(rng[pkg]))
            n1.follower.drain()
            if state != "inflight":
                n2.follower.drain()
            if state == "ahead":
                n0.index.insert(_rows(rng[pkg]))
                n1.follower.drain()
            _stop(n0.shipper)
            mbx.fail_peer(0, "killed")
            recs[pkg] = _elect(n1, n2)
        for r in (1, 2):
            a, b = recs["port"][r], recs["ref"][r]
            for f in ("winner", "term", "round", "survivors", "votes",
                      "promoted", "attempts", "extra"):
                assert getattr(a, f) == getattr(b, f), (r, f)
        t_nodes, j_nodes = fleets["port"][1], fleets["ref"][1]
        for t, j in zip(t_nodes[1:], j_nodes[1:]):
            assert (t.role, t.leader, t.index.term, t.index._term_start) \
                == (j.role, j.leader, j.index.term, j.index._term_start)
        for pkg, (mbx, (n0, n1, n2)) in fleets.items():
            if state == "inflight":
                n2.follower.catch_up(timeout=60.0)
            n1.index.insert(_rows(rng[pkg]))
            n2.follower.drain()
        assert t_nodes[2].index.content_crc() == \
            j_nodes[2].index.content_crc() == \
            j_nodes[1].index.content_crc()
        # a minority never elects, in either package
        for pkg, (mbx, nodes) in fleets.items():
            mbx.fail_peer(1, "killed")
            with pytest.raises(Exception, match="quorum"):
                nodes[2].run_election()
            assert nodes[2].role == "follower"
    finally:
        for mbx, nodes in fleets.values():
            _teardown(*nodes)


# ---------------------------------------------------------------------------
# the three-process SIGKILL witness
# ---------------------------------------------------------------------------


class TestFailoverChaos:
    @pytest.mark.slow
    def test_kill_leader_quorum_promotes_zero_loss(self):
        """A 3-node TCP fleet, its leader SIGKILLed mid-stream: the
        survivors elect the most caught-up follower, writes resume,
        every client-acked seq survives equal to a clean twin, and the
        old leader rejoins, truncates its suffix behind the typed fence
        and converges."""
        worker = os.path.join(_REPO, "tests", "_torch_failover_worker.py")
        env2 = dict(os.environ)
        env2["PYTHONPATH"] = _REPO + os.pathsep + env2.get(
            "PYTHONPATH", "")
        p = subprocess.run([sys.executable, worker, "orchestrate"],
                           cwd=_REPO, env=env2, capture_output=True,
                           text=True, timeout=480)
        assert p.returncode == 0, p.stdout + p.stderr
        assert "FAILOVER_CHAOS_OK" in p.stdout, p.stdout
