"""The port's WAL shipping (``raft_tpu_torch.neighbors.wal_ship``)
against the reference's ``raft_tpu.neighbors.wal_ship`` on the CPU:
``tests/test_durability.py``'s ``TestWalShipping``, ``TestReplicaSpawn``
and ``TestDurabilityChaos`` cases (its scrub, knob, partial-fit and
fixture cases are in ``tests/test_torch_scrub.py`` and
``tests/test_torch_streaming.py``), then the two packages on one wire.

Where both packages build an index they share the data and the
reference's trained centroids, so they pack alike. A leader of either
package ships to a follower of either through one in-process mailbox
(the frames are numpy uint8 arrays, which both mailboxes carry).

Tolerances: all exact. ``content_crc()`` (ids, rows in id order and
centroids), frame bytes, journal files, cursors and counters are
compared bit for bit.

The replica cases serve brute-force kNN, as ``tests/test_torch_replica.py``
does (the port's ``IvfMnmgKnnService`` needs a mesh-carved index).

The two-process witnesses spawn ``tests/_torch_durability_worker.py``
(no jax), each process bounded at 100 s: a follower fed live records
over TCP (tier 1), and the reference's SIGKILL-and-restart witness
(marked slow, as the reference's).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raft_tpu.comms.comms import _Mailbox as RBox
from raft_tpu.neighbors import streaming as jst
from raft_tpu.neighbors import wal_ship as jws
from raft_tpu_torch import device_resources, obs
from raft_tpu_torch.comms.comms import _Mailbox
from raft_tpu_torch.core.resources import DeviceUnavailableError
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.neighbors.streaming import (MutationLog, StreamingError,
                                                StreamingIndex, WalGapError,
                                                _coarse_assign, stream_build)
from raft_tpu_torch.neighbors.wal_ship import (TAG_CATCHUP, TAG_WAL,
                                               WalFollower, WalShipper,
                                               bootstrap_follower)
from raft_tpu_torch.obs import metrics as obs_metrics
from raft_tpu_torch.serve.loadgen import catchup_under_load

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = device_resources("cpu")

N, D, L = 160, 8, 8


def _leader(tmp_path, n=N, seed=3):
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(n, D)).astype(np.float32)
    idx = stream_build(CPU, db, L, seed=0, max_iter=4,
                       directory=str(tmp_path / "leader"))
    return idx, rng


def _rows(rng, m=12):
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


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if f.endswith(".ckpt")}


def _down(shipper):
    if shipper._thread is not None:
        shipper.stop()
    shipper.detach()


# ---------------------------------------------------------------------------
# WAL shipping in the port
# ---------------------------------------------------------------------------


class TestWalShipping:
    def _pair(self, tmp_path, *, follower_dir=True, serve=True):
        leader, rng = _leader(tmp_path)
        mbx = _Mailbox()
        shipper = WalShipper(leader, mbx, 0, [1],
                             poll_interval=0.01).attach()
        if serve:
            shipper.start()                     # answers catch-up
        fdir = str(tmp_path / "follower") if follower_dir else None
        fidx = bootstrap_follower(CPU, dim=D, n_lists=L, directory=fdir)
        wf = WalFollower(fidx, mbx, 1, 0)
        return leader, rng, mbx, shipper, fidx, wf

    def test_live_shipping_converges_bit_equal(self, tmp_path):
        leader, rng, mbx, shipper, fidx, wf = self._pair(tmp_path)
        rpt = wf.catch_up(timeout=30.0)         # blank cursor: snapshot
        assert rpt.snapshot and wf.resyncs == 1
        assert fidx.content_crc() == leader.content_crc()
        ids = leader.insert(_rows(rng))
        leader.delete(ids[::3])
        assert wf.drain() == 2
        assert fidx.content_crc() == leader.content_crc()
        assert wf.applied_seq == leader._applied_seq
        _down(shipper)

    def test_refit_ships_centroids(self, tmp_path):
        leader, rng, mbx, shipper, fidx, wf = self._pair(tmp_path)
        wf.catch_up(timeout=30.0)
        leader.insert(_rows(rng, 24))
        assert leader.maybe_refit(force=True)   # a KIND_CENTROIDS record
        wf.drain()
        # the CRC covers the centroids: the refit crossed the wire
        assert fidx.content_crc() == leader.content_crc()
        np.testing.assert_array_equal(fidx.flat.centroids.numpy(),
                                      leader.flat.centroids.numpy())
        _down(shipper)

    def test_gap_is_typed_and_drain_heals_it(self, tmp_path):
        leader, rng, mbx, shipper, fidx, wf = self._pair(tmp_path)
        wf.catch_up(timeout=30.0)
        leader.insert(_rows(rng))
        assert wf.drain() == 1
        leader.insert(_rows(rng))               # shipped...
        assert mbx.get_nowait(0, 1, TAG_WAL) is not None  # ...and lost
        leader.insert(_rows(rng))
        with pytest.raises(WalGapError) as ei:
            wf.drain(resync=False)
        assert ei.value.expected == wf.applied_seq + 1
        assert ei.value.got == ei.value.expected + 1
        # the steady drain turns the same gap into a catch-up round
        leader.insert(_rows(rng))
        wf.drain()
        assert fidx.content_crc() == leader.content_crc()
        assert wf.applied_seq == leader._applied_seq
        _down(shipper)

    def test_pruned_wal_gap_resyncs_via_snapshot(self, tmp_path):
        leader, rng, mbx, shipper, fidx, wf = self._pair(tmp_path)
        wf.catch_up(timeout=30.0)
        resyncs0 = wf.resyncs
        while mbx.get_nowait(0, 1, TAG_WAL) is not None:
            pass
        ids = leader.insert(_rows(rng))
        leader.delete(ids[:4])
        while mbx.get_nowait(0, 1, TAG_WAL) is not None:
            pass
        leader.compact(reason="prune")          # WAL pruned to horizon
        rpt = wf.catch_up(timeout=30.0)
        assert rpt.snapshot and wf.resyncs == resyncs0 + 1
        assert fidx.content_crc() == leader.content_crc()
        _down(shipper)

    def test_duplicates_are_idempotent(self, tmp_path):
        leader, rng, mbx, shipper, fidx, wf = self._pair(tmp_path)
        wf.catch_up(timeout=30.0)
        leader.insert(_rows(rng))
        payload = mbx.get_nowait(0, 1, TAG_WAL)
        mbx.put(0, 1, TAG_WAL, payload)         # delivered once...
        mbx.put(0, 1, TAG_WAL, payload)         # ...and again
        assert wf.drain() == 1
        assert wf.dups == 1
        assert fidx.content_crc() == leader.content_crc()
        _down(shipper)

    def test_mirror_restart_resumes_cursor(self, tmp_path):
        leader, rng, mbx, shipper, fidx, wf = self._pair(tmp_path)
        wf.catch_up(timeout=30.0)
        ids = leader.insert(_rows(rng))
        leader.delete(ids[::2])
        wf.drain()
        cursor = wf.applied_seq
        crc = fidx.content_crc()
        # a kill: drop the follower in memory and recover it from its
        # mirrored journal; the state and the cursor survive
        del fidx, wf
        fidx2 = StreamingIndex.recover(CPU, str(tmp_path / "follower"))
        assert fidx2._applied_seq == cursor
        assert fidx2.content_crc() == crc
        wf2 = WalFollower(fidx2, mbx, 1, 0)
        leader.insert(_rows(rng))               # the stream goes on
        wf2.drain()
        assert fidx2.content_crc() == leader.content_crc()
        _down(shipper)

    def test_catchup_under_load_holds_recall_floor(self, tmp_path,
                                                   live_obs):
        leader, rng, mbx, shipper, fidx, wf = self._pair(
            tmp_path, follower_dir=False)
        for _ in range(4):
            ids = leader.insert(_rows(rng))
            leader.delete(ids[::4])
        rep = catchup_under_load(wf, k=5, nprobe=L,
                                 target_seq=leader._applied_seq,
                                 rows=4, seed=1)
        _down(shipper)
        assert rep.applied_seq >= rep.target_seq
        assert rep.queries >= 1
        assert rep.min_recall >= 0.99, rep.as_dict()
        assert rep.resyncs == 1                 # blank cursor
        assert fidx.content_crc() == leader.content_crc()
        assert _counter(live_obs, "replica_catchups_total") >= 1
        snap = live_obs.snapshot().get("replica_catchup_seconds")
        assert snap and snap["series"][0]["count"] >= 1

    def test_shipper_validation(self, tmp_path):
        rng = np.random.default_rng(0)
        db = rng.normal(size=(96, D)).astype(np.float32)
        bare = stream_build(CPU, db, 4, seed=0, max_iter=4)
        mbx = _Mailbox()
        with pytest.raises(StreamingError, match="journaled"):
            WalShipper(bare, mbx, 0, [1])
        leader, _ = _leader(tmp_path)
        with pytest.raises(ValueError, match="follow itself"):
            WalShipper(leader, mbx, 0, [0, 1])
        with pytest.raises(ValueError, match="follow itself"):
            WalFollower(leader, mbx, 2, 2)
        s = WalShipper(leader, mbx, 0, [1]).attach()
        with pytest.raises(StreamingError, match="on_append"):
            WalShipper(leader, mbx, 0, [1]).attach()
        s.detach()
        with pytest.raises(ValueError, match="acks"):
            WalShipper(leader, mbx, 0, [1], acks="most")
        with pytest.raises(ValueError, match="acks count"):
            WalShipper(leader, mbx, 0, [1], acks=0)

    def test_shipper_error_surfaces_at_stop(self, tmp_path, monkeypatch):
        leader, rng, mbx, shipper, fidx, wf = self._pair(tmp_path,
                                                         serve=False)

        def boom():
            raise RuntimeError("poller broke")

        monkeypatch.setattr(shipper, "serve_catchup_once", boom)
        shipper.start()
        shipper._thread.join(timeout=10.0)
        with pytest.raises(StreamingError, match="shipper failed"):
            shipper.stop()
        shipper.detach()

    def test_bootstrap_follower_needs_a_device(self):
        """``res=None`` is the ``cuda:0`` handle, as ``stream_build``'s:
        without CUDA it raises instead of building on the host."""
        if torch.cuda.is_available():
            pytest.skip("CUDA present: cuda:0 is the default device")
        with pytest.raises(DeviceUnavailableError):
            bootstrap_follower(None, dim=D, n_lists=L)
        idx = bootstrap_follower(CPU, dim=D, n_lists=L)
        assert idx.device == torch.device("cpu")
        assert idx.n_live == 0 and idx.flat.n_lists == L


# ---------------------------------------------------------------------------
# fleet rejoin (ReplicaGroup.spawn)
# ---------------------------------------------------------------------------


class TestReplicaSpawn:
    OP = "knn_k4_l2"

    def _fleet(self, n=2):
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

        return X, ReplicaGroup([make_ex() for _ in range(n)]), make_ex

    def test_spawn_joins_at_vtime_floor(self):
        X, group, make_ex = self._fleet()
        with group:
            for _ in range(10):
                group.route(self.OP, X[:8])[1].result(timeout=60.0)
            floor = min(r.vtime for r in group.replicas)
            assert floor > 0.0
            rep = group.spawn("joiner", make_ex())
            assert rep.vtime == 0.0 and rep.healthy
            # the joiner is the fair queue's minimum, so it serves next,
            # and its clock snaps to the fleet's floor: no flood
            served, fut = group.route(self.OP, X[:8])
            fut.result(timeout=60.0)
            assert served.name == "joiner"
            assert served.vtime >= floor
        assert len(group.replicas) == 3

    def test_spawn_zero_post_warm_recompiles(self):
        X, group, make_ex = self._fleet()
        with group:
            group.route(self.OP, X[:8])[1].result(timeout=60.0)
            ex = make_ex()                      # warmed before routable
            group.spawn("joiner", ex, warm=False)
            traces0 = ex.stats.traces
            misses0 = ex.stats.exec_misses
            for _ in range(6):
                group.route(self.OP, X[:8])[1].result(timeout=60.0)
            assert ex.stats.requests > 0        # the joiner served
            assert ex.stats.traces == traces0
            assert ex.stats.exec_misses == misses0

    def test_spawn_validation(self):
        X, group, make_ex = self._fleet()
        with pytest.raises(ValueError, match="weight"):
            group.spawn("w", make_ex(), weight=0.0)
        with pytest.raises(ValueError, match="rejoin"):
            group.spawn("replica0", make_ex())


# ---------------------------------------------------------------------------
# the two-process witnesses
# ---------------------------------------------------------------------------


def _orchestrate(*extra):
    worker = os.path.join(_REPO, "tests", "_torch_durability_worker.py")
    env2 = dict(os.environ)
    env2["PYTHONPATH"] = _REPO + os.pathsep + env2.get("PYTHONPATH", "")
    p = subprocess.run([sys.executable, worker, "orchestrate", *extra],
                       cwd=_REPO, env=env2, capture_output=True,
                       text=True, timeout=400)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "DURABILITY_CHAOS_OK" in p.stdout, p.stdout
    return p.stdout


class TestDurabilityChaos:
    def test_two_process_shipping_converges(self):
        """A blank follower process fed over TCP by a leader process:
        snapshot resync, then live inserts, deletes and a refit's
        centroids; CRC equal to the leader and to a twin run in one
        process."""
        _orchestrate()

    @pytest.mark.slow
    def test_sigkill_restart_catchup_bit_equal(self):
        """The follower is SIGKILLed mid-stream, restarts from its
        mirrored journal and catches up under query load: CRC equal to
        the leader and to a twin that was never killed; the recall floor
        held throughout."""
        out = _orchestrate("--kill")
        assert "resumed=" in out


# ---------------------------------------------------------------------------
# the two packages on one wire
# ---------------------------------------------------------------------------


def _pair(tmp_path):
    """(reference leader, port leader) over one database and the
    reference's trained centroids, journaled under ``tmp_path/{ref,port}``
    (byte-identical journals)."""
    db = np.random.default_rng(3).normal(size=(N, D)).astype(np.float32)
    jidx = jst.stream_build(None, db, L, seed=0, max_iter=4,
                            directory=str(tmp_path / "ref"))
    c = np.array(jidx.flat.centroids)
    flat = ivf_flat.build(CPU, torch.from_numpy(db), L,
                          centroids=torch.from_numpy(c))
    idx = StreamingIndex(flat, log=MutationLog(str(tmp_path / "port")),
                         res=CPU)
    dist, _ = _coarse_assign(db, flat.centroids)
    idx.drift.set_baseline(float(np.mean(dist)))
    with idx._lock:
        idx._write_epoch_locked(crash=False)
    return jidx, idx


# (package name, shipper class, follower class, bootstrap, mailbox)
_PKG = {
    "ref": (jws.WalShipper, jws.WalFollower,
            lambda d: jws.bootstrap_follower(None, dim=D, n_lists=L,
                                             directory=d), RBox),
    "port": (WalShipper, WalFollower,
             lambda d: bootstrap_follower(CPU, dim=D, n_lists=L,
                                          directory=d), _Mailbox),
}

PATHS = ["live", "snapshot", "pruned_gap", "centroids", "mirror_restart"]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("lead,follow", [("ref", "port"), ("port", "ref")])
def test_follower_of_either_package_converges(tmp_path, lead, follow,
                                              path):
    """A leader of one package ships to a follower of the other; the
    follower reaches the leader's ``content_crc()`` through each path:
    live records, a snapshot resync from blank, a pruned-WAL gap, a
    refit's KIND_CENTROIDS record, and a restart from the mirror
    journal."""
    jidx, idx = _pair(tmp_path)
    leader = jidx if lead == "ref" else idx
    Ship = _PKG[lead][0]
    _, Follow, boot, Box = _PKG[follow]
    mbx = Box()
    sh = Ship(leader, mbx, 0, [1], poll_interval=0.01).attach()
    sh.start()
    fdir = str(tmp_path / "follower")
    fidx = boot(fdir)
    wf = Follow(fidx, mbx, 1, 0)
    rng = np.random.default_rng(5)
    try:
        rpt = wf.catch_up(timeout=60.0)         # blank: a snapshot
        assert rpt.snapshot
        assert fidx.content_crc() == leader.content_crc()
        ids = leader.insert(_rows(rng))
        leader.delete(ids[::3])
        if path == "live":
            assert wf.drain() == 2
        elif path == "snapshot":
            # a second blank follower of the same package, resynced
            # while the leader holds live records past its epoch
            wf.drain()
            f2 = boot(str(tmp_path / "follower2"))
            sh.followers.append(2)
            rpt2 = Follow(f2, mbx, 2, 0).catch_up(timeout=60.0)
            assert rpt2.snapshot
            assert f2.content_crc() == leader.content_crc()
        elif path == "pruned_gap":
            while mbx.get_nowait(0, 1, TAG_WAL) is not None:
                pass
            leader.compact(reason="prune")
            assert wf.catch_up(timeout=60.0).snapshot
        elif path == "centroids":
            wf.drain()
            leader.insert(_rows(rng, 24))
            assert leader.maybe_refit(force=True)
            wf.drain()
            np.testing.assert_array_equal(
                np.asarray(fidx.flat.centroids),
                np.asarray(leader.flat.centroids))
        else:
            wf.drain()
            crc, cursor = fidx.content_crc(), wf.applied_seq
            rec = (StreamingIndex.recover(CPU, fdir) if follow == "port"
                   else jst.StreamingIndex.recover(None, fdir))
            assert rec.content_crc() == crc
            assert rec._applied_seq == cursor
            fidx, wf = rec, Follow(rec, mbx, 1, 0)
            leader.insert(_rows(rng))
            assert wf.drain() == 1
        assert fidx.content_crc() == leader.content_crc()
        assert wf.applied_seq == leader._applied_seq
    finally:
        _down(sh)


def test_frames_and_mirror_journals_equal_the_reference(tmp_path):
    """Both packages' leaders take one mutation sequence: every live
    frame and the catch-up snapshot frame are byte-equal. A reference
    leader then feeds one follower of each package: their mirror
    journals hold the same files, byte for byte."""
    jidx, idx = _pair(tmp_path)
    jbox, tbox = RBox(), _Mailbox()
    jsh = jws.WalShipper(jidx, jbox, 0, [1, 2], poll_interval=0.01)
    tsh = WalShipper(idx, tbox, 0, [1], poll_interval=0.01)
    jsh.attach()
    tsh.attach()
    jf = jws.WalFollower(jws.bootstrap_follower(
        None, dim=D, n_lists=L, directory=str(tmp_path / "jf")), jbox, 1,
        0)
    tf = WalFollower(bootstrap_follower(
        CPU, dim=D, n_lists=L, directory=str(tmp_path / "tf")), jbox, 2, 0)
    rng = np.random.default_rng(9)
    try:
        # the snapshot frames, served by hand (no poller threads)
        jsh._serve(1, 0)
        tsh._serve(1, 0)
        for want_end in (False, True):
            a = jbox.get_nowait(0, 1, TAG_CATCHUP)
            b = tbox.get_nowait(0, 1, TAG_CATCHUP)
            assert a.tobytes() == b.tobytes()
        jsh.start()
        for f in (jf, tf):
            assert f.catch_up(timeout=60.0).snapshot
        steps = [lambda ix, r: ix.insert(r),
                 lambda ix, r: ix.delete(np.arange(0, 40, 3)),
                 lambda ix, r: ix.insert(np.concatenate([r] * 20))]
        for step in steps:
            rows = _rows(rng)
            step(jidx, rows)
            step(idx, rows)
            a = jbox.get_nowait(0, 1, TAG_WAL)
            jbox.put(0, 1, TAG_WAL, a)          # put back for jf
            b = tbox.get_nowait(0, 1, TAG_WAL)
            assert a.tobytes() == b.tobytes()
            jf.drain()
            tf.drain()
        assert idx.content_crc() == jidx.content_crc()
        assert jf.index.content_crc() == tf.index.content_crc() == \
            jidx.content_crc()
        assert _files(tmp_path / "jf") == _files(tmp_path / "tf")
        assert _files(tmp_path / "ref") == _files(tmp_path / "port")
    finally:
        _down(jsh)
        tsh.detach()
