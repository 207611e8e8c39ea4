"""The port's streaming ingest on the serving path
(``raft_tpu_torch.serve.ingest``) against the reference's
``raft_tpu.serve.ingest`` on the CPU: ``tests/test_streaming.py``'s
``TestServe`` cases, the served bits of ``StreamingKnnService`` beside
the reference service's, the leader redirect against a stand-in
election object with the reference's attributes, and the recall
scorer of ``loadgen.streaming_loop`` beside the reference's.

Tolerances:
- exact: a served response against the port's own eager search, ids
  against the reference's, the scorer's ids against the reference's;
- distances between the packages: within ``REL`` of the row's scale
  |q|^2 + max|x|^2 (two f32 summation orders at tier 'high');
- recall: the reference test's floors (min 0.5, mean 0.85).
"""

import numpy as np
import pytest
import torch

from raft_tpu import serve as jserve
from raft_tpu.neighbors import streaming as jst
from raft_tpu.serve import ingest as jingest
from raft_tpu.serve import loadgen as jloadgen
from raft_tpu_torch import device_resources, serve
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.neighbors.streaming import StreamingIndex, stream_build
from raft_tpu_torch.serve import ingest, loadgen

CPU = device_resources("cpu")
REL = 1e-5


def _db(n=256, d=8, seed=3):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(
        np.float32)


def _rows(m, d=8, seed=11):
    return np.random.default_rng(seed).normal(size=(m, d)).astype(
        np.float32)


def _mk(n=256, seed=3, **kw):
    db = _db(n, seed=seed)
    return db, stream_build(CPU, db, 8, seed=0, max_iter=4, **kw)


def n(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


@pytest.fixture
def controller():
    db, idx = _mk(repack_slack=64)
    idx.compact(reason="provision")
    svc = serve.StreamingKnnService(idx, k=5, nprobe=7)
    ctl = serve.IngestController(
        idx, [svc], policy=serve.BatchPolicy(max_batch=8, max_wait_ms=2.0),
        compact_interval=30.0, refit=False, warm_buckets=[8])
    with ctl:
        yield db, idx, svc, ctl


class TestServe:
    def test_batched_serve_matches_direct_search_bits(self, controller):
        db, idx, svc, ctl = controller
        q = db[:4]
        d, i = ctl.submit(svc.name, q).result(timeout=30.0)
        ed, ei = idx.search(q, k=5, nprobe=7)
        assert torch.equal(d, ed) and torch.equal(i, ei)

    def test_same_shape_swap_serves_immediately(self, controller):
        db, idx, svc, ctl = controller
        q = db[7:11]
        _, i0 = ctl.submit(svc.name, q).result(timeout=30.0)
        assert 7 in n(i0)
        swaps0, epoch0 = ctl.swaps, svc.serve_epoch
        traces0 = ctl.executor.stats.traces
        ctl.delete([7])
        assert ctl.swaps == swaps0 and svc.serve_epoch == epoch0, \
            "a delete is a same-shape swap — no epoch bump"
        assert ctl.refreshes >= 1
        _, i1 = ctl.submit(svc.name, q).result(timeout=30.0)
        assert 7 not in n(i1)
        assert ctl.executor.stats.traces == traces0
        assert ctl.rewarm_traces == 0

    def test_shape_changing_swap_prewarms_then_serves(self, controller):
        db, idx, svc, ctl = controller
        swaps0 = ctl.swaps
        traces0 = ctl.executor.stats.traces
        new = _rows(700, seed=51)
        ctl.insert(new)
        assert ctl.swaps > swaps0, "an overflow repack must bump the epoch"
        # the pre-warm's compiles count apart, off the query path
        assert ctl.rewarm_traces >= 1 and ctl.rewarm_windows
        warmed = ctl.executor.stats.traces
        assert warmed - traces0 == ctl.rewarm_traces
        q = new[:4]
        d, i = ctl.submit(svc.name, q).result(timeout=30.0)
        ed, ei = idx.search(q, k=5, nprobe=7)
        assert torch.equal(d, ed) and torch.equal(i, ei)
        assert ctl.executor.stats.traces == warmed, \
            "the query after the swap compiled"
        ctl.executor._get_executable(svc, 16)
        stale = [key for key in ctl.executor._executables
                 if key[0] == svc.name and key[1] < svc.serve_epoch]
        assert not stale

    def test_prepare_publish_protocol(self, controller):
        db, idx, svc, ctl = controller
        assert svc.prepare() is None, "serving snapshot already current"
        idx.delete([3])                       # direct: bypass controller
        pending, version = svc.prepare()
        assert pending[0] == svc.serve_epoch  # same shapes, same epoch
        assert svc.publish(pending, version) is False
        idx.insert(_rows(700, seed=52))       # overflow: shapes change
        pending, version = svc.prepare()
        assert pending[0] == svc.serve_epoch + 1
        assert svc.publish(pending, version) is True

    def test_validation(self):
        db, idx = _mk(n=160)
        with pytest.raises(ValueError, match="nprobe"):
            serve.StreamingKnnService(idx, k=4, nprobe=8)
        db2, idx2 = _mk(n=160, seed=9)
        svc = serve.StreamingKnnService(idx2, k=4, nprobe=7)
        with pytest.raises(ValueError, match="different"):
            serve.IngestController(idx, [svc])

    def test_streaming_loop_recall_floor_across_swaps(self):
        """Sustained ingest and deletes racing concurrent queries
        through at least one shape-changing swap, each response scored
        against exact search over the snapshot window it was served
        from."""
        db, idx = _mk(repack_slack=48)
        idx.compact(reason="provision")
        svc = serve.StreamingKnnService(idx, k=5, nprobe=7)
        ctl = serve.IngestController(
            idx, [svc], policy=serve.BatchPolicy(max_batch=8,
                                                 max_wait_ms=2.0),
            compact_interval=0.05, refit=False, warm_buckets=[8])
        with ctl:
            rep = serve.streaming_loop(
                ctl, svc.name, clients=3, rows=4, duration_s=2.0,
                ingest_rows=48, ingest_interval_s=0.02,
                delete_frac=0.3, seed=1)
        assert rep.failed == 0
        assert rep.queries > 0 and rep.ingest_batches >= 2
        assert rep.swaps >= 1, "the run must cross a shape swap"
        assert rep.min_recall >= 0.5, rep.as_dict()
        assert rep.mean_recall >= 0.85, rep.as_dict()
        assert rep.n_live_final == idx.n_live


def _pair(n_rows=256, **kw):
    db = _db(n_rows)
    jidx = jst.stream_build(None, db, 8, seed=0, max_iter=4, **kw)
    flat = ivf_flat.build(CPU, torch.from_numpy(db), 8,
                          centroids=torch.from_numpy(
                              np.array(jidx.flat.centroids)))
    return db, jidx, StreamingIndex(flat, res=CPU, **kw)


class TestAgainstReference:
    def test_served_bits_match_reference_service(self):
        db, jidx, idx = _pair(repack_slack=16)
        for ix in (idx, jidx):
            ix.compact(reason="provision")
            ix.insert(_rows(12))
            ix.delete(np.arange(0, 40, 3))
        svc = serve.StreamingKnnService(idx, k=5, nprobe=7)
        jsvc = jserve.StreamingKnnService(jidx, k=5, nprobe=7)
        assert svc.name == jsvc.name
        ex = serve.Executor([svc], policy=serve.BatchPolicy(
            max_batch=8, max_wait_ms=1.0))
        jex = jserve.Executor([jsvc], policy=jserve.BatchPolicy(
            max_batch=8, max_wait_ms=1.0))
        ex.warm([8])
        jex.warm([8])
        q = db[20:26]
        with ex, jex:
            d, i = ex.submit(svc.name, q).result(timeout=30.0)
            jd, ji = jex.submit(jsvc.name, q).result(timeout=60.0)
        np.testing.assert_array_equal(n(i), np.asarray(ji))
        rows = idx.live_rows()[0].astype(np.float64)
        band = REL * ((q.astype(np.float64) ** 2).sum(1)
                      + (rows ** 2).sum(1).max())
        assert (np.abs(n(d) - np.asarray(jd)) <= band[:, None] + 1e-6).all()
        assert svc.epilogue() == jsvc.epilogue()

    def test_recall_scorer_matches_reference(self):
        db, jidx, idx = _pair()
        for ix in (idx, jidx):
            ix.delete(np.arange(0, 60, 4))
        q = _rows(6, seed=23)
        np.testing.assert_array_equal(
            loadgen._snapshot_exact_ids(idx.snapshot, q, 5),
            jloadgen._snapshot_exact_ids(jidx.snapshot, q, 5))


class _Election:
    """A stand-in with the reference election node's attributes."""

    def __init__(self, index, *, leader=0, rank=1, role="follower"):
        self.index = index
        self.leader = leader
        self.rank = rank
        self.role = role
        self.on_promote = self.on_repoint = self.on_demote = None
        self.started = self.stopped = False

    def is_leader(self):
        return self.role == "leader"

    def start(self):
        self.started = True

    def stop(self):
        self.stopped = True


class TestLeader:
    def test_follower_write_redirects_typed(self):
        db, idx = _mk(n=160)
        svc = serve.StreamingKnnService(idx, k=4, nprobe=7)
        el = _Election(idx)
        ctl = serve.IngestController(idx, [svc], election=el,
                                     compact_interval=30.0, refit=False,
                                     warm_buckets=[8])
        assert not ctl.is_leader() and ctl.leader == 0
        with pytest.raises(ingest.NotLeaderError) as ei:
            ctl.insert(_rows(3))
        assert ei.value.leader == 0 and ei.value.rank == 1
        assert str(ei.value) == str(jingest.NotLeaderError(leader=0,
                                                           rank=1))
        with pytest.raises(ingest.NotLeaderError):
            ctl.delete([1])
        assert idx.n_live == 160
        with ctl:
            assert el.started
            # a promotion rolls the serving snapshot forward on the
            # node's thread, then writes are taken
            idx.delete([5])
            el.role, el.leader = "leader", 1
            refreshes = ctl.refreshes
            el.on_promote(el)
            assert ctl.refreshes == refreshes + 1
            assert ctl.is_leader() and ctl.leader == 1
            ids = ctl.insert(_rows(3))
            np.testing.assert_array_equal(ids, [160, 161, 162])
        assert el.stopped

    def test_election_wiring_validation(self):
        db, idx = _mk(n=160)
        db2, idx2 = _mk(n=160, seed=9)
        svc = serve.StreamingKnnService(idx, k=4, nprobe=7)
        with pytest.raises(ValueError, match="different"):
            serve.IngestController(idx, [svc], election=_Election(idx2))
        with pytest.raises(ValueError, match="shipper= OR election="):
            serve.IngestController(idx, [svc], election=_Election(idx),
                                   shipper=type("S", (), {"index": idx})())
