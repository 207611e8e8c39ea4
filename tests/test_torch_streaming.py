"""The port's streaming IVF-Flat index
(``raft_tpu_torch.neighbors.streaming``) against the reference's
``raft_tpu.neighbors.streaming`` on the CPU: ``tests/test_streaming.py``'s
cases but the serving ones (``tests/test_torch_ingest.py``), the frozen
epoch fixture of ``tests/test_durability.py``, the journal tests of
``tests/test_failover.py`` that need no shipping, and the two packages
on one journal.

Where both packages build an index they share the data and the
centroids (the reference's trained ones: JAX's and torch's random draws
share no bits), so they pack alike. Tolerances:
- exact: ids, ``content_crc()``, sizes, every journal file's bytes, the
  port's own searches against its rebuilds (bitwise);
- distances between the packages: within ``REL`` of the row's scale
  |q|^2 + max|x|^2 (two f32 summation orders at tier 'high');
- refit centroids between the packages: within ``REFIT_TOL`` (the
  mini-batch steps' f32 rounding).

The reference's compactor test asserts that a fresh 160-row build is
due for compaction; whether it is depends on how the rows fall in the
lists, and it is not (fewer than 20% of the lists have full tails).
The port's case holds ``should_compact()`` equal to the reference's at
every step and the test's stated contract instead: a repack with slack
clears both trigger fractions.
"""

import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import _torch_streaming_chaos_worker as chaos
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import streaming as jst
from raft_tpu_torch import device_resources, serve
from raft_tpu_torch.comms.faults import CrashPointError, FaultInjector
from raft_tpu_torch.core import env
from raft_tpu_torch.core.checkpoint import restore_checkpoint
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.neighbors.streaming import (Compactor, DriftGauge,
                                                MutationLog, RecoveryError,
                                                StreamingError,
                                                StreamingIndex, StreamingMnmg,
                                                _coarse_assign,
                                                _flat_from_live,
                                                _search_snapshot, stream_build)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FIXTURE = os.path.join(_REPO, "tests", "data", "streaming_epoch_v1.ckpt")
CPU = device_resources("cpu")
REL = 1e-5
REFIT_TOL = 1e-4

CRASH_POINTS = ["ingest.pre_journal", "ingest.post_journal",
                "compact.pre_pack", "compact.pre_commit",
                "compact.mid_write", "compact.post_commit",
                "compact.post_swap"]


def _db(n=160, d=8, seed=3):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(
        np.float32)


def _rows(m, d=8, seed=11):
    return np.random.default_rng(seed).normal(size=(m, d)).astype(
        np.float32)


def _mk(n=160, d=8, n_lists=8, seed=3, **kw):
    db = _db(n, d, seed)
    return db, stream_build(CPU, db, n_lists, seed=0, max_iter=4, **kw)


def _port_from(db, centroids, directory=None, **kw):
    """``stream_build`` with the centroids given (no training)."""
    flat = ivf_flat.build(CPU, torch.from_numpy(db), centroids.shape[0],
                          centroids=torch.from_numpy(np.array(centroids)))
    log = MutationLog(directory) if directory is not None else None
    idx = StreamingIndex(flat, log=log, res=CPU, **kw)
    dist, _ = _coarse_assign(db, flat.centroids)
    idx.drift.set_baseline(float(np.mean(dist)))
    if log is not None:
        with idx._lock:
            idx._write_epoch_locked(crash=False)
    return idx


def _pair(tmp_path=None, n=160, seed=3, **kw):
    """(db, reference index, port index) over one database and the
    reference's trained centroids, journaled under ``tmp_path/{ref,port}``
    when given."""
    db = _db(n, seed=seed)
    jdir = None if tmp_path is None else str(tmp_path / "ref")
    tdir = None if tmp_path is None else str(tmp_path / "port")
    jidx = jst.stream_build(None, db, 8, seed=0, max_iter=4,
                            directory=jdir, **kw)
    tidx = _port_from(db, np.asarray(jidx.flat.centroids), tdir, **kw)
    return db, jidx, tidx


def n(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _agree(got, want, q, rows):
    """Port against reference: ids equal, distances within REL of the
    row's scale."""
    (gd, gi), (wd, wi) = (n(a) for a in got), (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi, wi)
    q64, x64 = q.astype(np.float64), rows.astype(np.float64)
    band = REL * ((q64 ** 2).sum(1) + (x64 ** 2).sum(1).max())
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    assert (np.abs(gd - np.where(fin, wd, gd))
            <= band[:, None] + 1e-6).all()


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if f.endswith(".ckpt")}


def _shapes(snap):
    f = snap.flat
    return [tuple(t.shape) for t in (f.centroids, f.packed_db,
                                     f.packed_ids, f.starts, f.sizes,
                                     snap.tomb_words)]


# ---------------------------------------------------------------------------
# mutation basics
# ---------------------------------------------------------------------------


class TestMutation:
    def test_insert_assigns_sequential_ids_and_serves(self):
        db, jidx, idx = _pair()
        new = _rows(12)
        ids = idx.insert(new)
        np.testing.assert_array_equal(ids, np.arange(160, 172))
        np.testing.assert_array_equal(ids, jidx.insert(new))
        assert idx.n_live == 172 and idx.next_id == 172
        _, got = idx.search(new, k=1, nprobe=idx.flat.n_lists)
        np.testing.assert_array_equal(n(got)[:, 0], ids)
        assert idx.content_crc() == jidx.content_crc()

    def test_fitting_insert_and_delete_never_retrace(self):
        """The snapshot keeps every tensor's shape across a delete and a
        fitting insert, and a warmed executor serving it records no
        compile event (the port's form of the reference's jit cache
        count)."""
        db, idx = _mk()
        idx.compact(reason="provision")
        svc = serve.StreamingKnnService(idx, k=4, nprobe=7)
        ex = serve.Executor([svc], policy=serve.BatchPolicy(
            max_batch=16, max_wait_ms=1.0))
        ex.warm([16])
        traces, epoch0 = ex.stats.traces, idx.epoch
        shapes = _shapes(idx.snapshot)
        assert idx.delete([3, 5]) == 2
        idx.insert(_rows(4))
        assert idx.epoch == epoch0, "fitting insert must not repack"
        assert _shapes(idx.snapshot) == shapes
        assert svc.refresh() is False, "a same-shape swap bumped the epoch"
        with ex:
            d, i = ex.submit(svc.name, db[:16]).result(timeout=30.0)
        ed, ei = idx.search(db[:16], k=4, nprobe=7)
        assert torch.equal(d, ed) and torch.equal(i, ei)
        assert ex.stats.traces == traces, \
            "delete / fitting insert changed a served program's shapes"

    def test_delete_excludes_and_is_idempotent(self):
        db, jidx, idx = _pair()
        assert idx.delete([7, 7, 9]) == 2 == jidx.delete([7, 7, 9])
        assert idx.delete([7, 9]) == 0
        assert idx.n_live == 158
        _, got = idx.search(db[7:8], k=4, nprobe=idx.flat.n_lists)
        assert 7 not in n(got)
        rows, ids = idx.live_rows()
        assert 7 not in ids and 9 not in ids
        assert rows.shape[0] == 158
        np.testing.assert_array_equal(ids, jidx.live_rows()[1])

    def test_overflow_insert_repacks_under_new_epoch(self):
        db, jidx, idx = _pair()
        epoch0 = idx.epoch
        big = _rows(200, seed=13)
        ids = idx.insert(big)
        jidx.insert(big)
        assert idx.epoch > epoch0 and idx.epoch == jidx.epoch
        assert idx.n_live == 360 and idx.next_id == 360
        rows, live = idx.live_rows()
        np.testing.assert_array_equal(live, np.arange(360))
        np.testing.assert_array_equal(rows[ids], big)
        np.testing.assert_array_equal(idx.flat.caps, jidx.flat.caps)
        assert idx.content_crc() == jidx.content_crc()

    def test_validation(self):
        db, idx = _mk()
        with pytest.raises(ValueError, match=r"rows must be"):
            idx.insert(np.zeros((3, 5), np.float32))
        with pytest.raises(ValueError, match=r"labels must be"):
            idx.insert(_rows(2), labels=np.asarray([0, 99]))
        with pytest.raises(ValueError, match=r"ids must be in"):
            idx.delete([700])
        with pytest.raises(ValueError, match=r"n_live"):
            idx.search(db[:2], k=200, nprobe=8)
        with pytest.raises(ValueError, match=r"nprobe"):
            idx.search(db[:2], k=2, nprobe=0)
        assert idx.insert(np.zeros((0, 8), np.float32)).size == 0
        assert idx.delete(np.zeros((0,), np.int64)) == 0

    def test_snapshot_keeps_its_bits_across_mutation(self):
        """A published snapshot's tensors are never written: a search of
        a snapshot taken before a delete and a fitting insert (both
        in-place on the host and the packed tensors in a naive port)
        gives the same bits after them."""
        db, idx = _mk(repack_slack=16)
        idx.compact(reason="provision")
        snap = idx.snapshot
        words = snap.tomb_words.clone()
        packed = snap.flat.packed_db.clone()
        before = _search_snapshot(snap, torch.from_numpy(db[:16]), 4, 7)
        idx.delete(np.arange(0, 40, 2))
        idx.insert(db[:8] + 1e-3)
        assert idx.epoch == snap.epoch and idx.version > snap.version
        after = _search_snapshot(snap, torch.from_numpy(db[:16]), 4, 7)
        assert torch.equal(before[0], after[0])
        assert torch.equal(before[1], after[1])
        assert torch.equal(words, snap.tomb_words)
        assert torch.equal(packed, snap.flat.packed_db)
        assert [s.version for s in idx.recent_snapshots()][-3:] == \
            [snap.version, snap.version + 1, snap.version + 2]


# ---------------------------------------------------------------------------
# tombstone exactness: ties + NaN, both epilogues
# ---------------------------------------------------------------------------


def _dirty():
    """The adversarial database: an exact duplicate pair and a NaN row,
    built on given centroids so the quantizer never sees the NaN."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(512, 8)).astype(np.float32)
    X[100] = X[7]
    X[200] = X[7]
    X[300] = np.nan
    return X


def _dirty_stream(X):
    flat = ivf_flat.build(CPU, torch.from_numpy(X), 8,
                          centroids=torch.from_numpy(X[:8]))
    return StreamingIndex(flat)


def _force(flat, tomb_words, q, k, nprobe, use_radix):
    return ivf_flat._search_body(
        torch.from_numpy(q), flat.centroids, flat.packed_db,
        flat.packed_ids, flat.starts, flat.sizes, tomb_words, k=k,
        nprobe=nprobe, cap_max=flat.cap_max, metric=flat.metric,
        use_radix=use_radix)


def _jforce(flat, tomb_words, q, k, nprobe):
    return jivf._search_jit(q, flat.centroids, flat.packed_db,
                            flat.packed_ids, flat.starts, flat.sizes,
                            tomb_words, k=k, nprobe=nprobe,
                            cap_max=flat.cap_max, metric=flat.metric,
                            use_radix=False)


def _equal_nan(a, b):
    np.testing.assert_array_equal(n(a), n(b))


class TestTombstoneExactness:
    @pytest.mark.parametrize("use_radix", [False, True])
    def test_delete_bit_identical_to_rebuild(self, use_radix):
        X = _dirty()
        idx = _dirty_stream(X)
        idx.delete([100, 300, 20])
        snap = idx.snapshot
        rows, ids = idx.live_rows()
        rebuilt = _flat_from_live(rows, ids, snap.flat.centroids,
                                  snap.flat.metric)
        q = np.concatenate([X[7:8], X[100:101], X[40:44]])
        md, mi = _force(snap.flat, snap.tomb_words, q, 8, 7, use_radix)
        rd, ri = _force(rebuilt, None, q, 8, 7, use_radix)
        _equal_nan(md, rd)
        _equal_nan(mi, ri)
        assert not np.isin(n(mi), [100, 300, 20]).any()
        # the reference on the same rows and centroids
        jidx = jst.StreamingIndex(jivf.build(None, X, 8, centroids=X[:8]))
        jidx.delete([100, 300, 20])
        js = jidx.snapshot
        _agree((md, mi), _jforce(js.flat, js.tomb_words, q, 8, 7), q,
               rows)

    @pytest.mark.parametrize("use_radix", [False, True])
    def test_zero_bitset_is_value_level_noop(self, use_radix):
        X = _dirty()
        snap = _dirty_stream(X).snapshot
        q = np.concatenate([X[7:8], X[300:301], X[40:44]])
        zd, zi = _force(snap.flat, snap.tomb_words, q, 8, 7, use_radix)
        nd, ni = _force(snap.flat, None, q, 8, 7, use_radix)
        _equal_nan(zd, nd)
        _equal_nan(zi, ni)

    def test_unrelated_delete_leaves_results_bit_identical(self):
        X = _dirty()
        idx = _dirty_stream(X)
        q = np.concatenate([X[7:8], X[40:44]])
        d0, i0 = idx.search(q, k=4, nprobe=7)
        victims = sorted(set(range(450, 470)) - set(n(i0).ravel().tolist()))
        idx.delete(victims)
        d1, i1 = idx.search(q, k=4, nprobe=7)
        _equal_nan(d0, d1)
        _equal_nan(i0, i1)

    def test_exact_path_matches_brute_force_on_live(self):
        from raft_tpu_torch.neighbors import knn

        X = _dirty()
        idx = _dirty_stream(X)
        idx.delete([100, 300])
        rows, ids = idx.live_rows()
        q = np.concatenate([X[7:8], X[40:44]])
        bd, bi = knn(CPU, torch.from_numpy(rows), torch.from_numpy(q), k=8)
        ad, ai = idx.search(q, k=8, nprobe=idx.flat.n_lists)
        _equal_nan(bd, ad)
        np.testing.assert_array_equal(ids[n(bi)], n(ai))


# ---------------------------------------------------------------------------
# WAL + recovery
# ---------------------------------------------------------------------------


class TestRecovery:
    def test_replay_is_bit_identical(self, tmp_path):
        db, idx = _mk(directory=str(tmp_path))
        idx.insert(_rows(24))
        idx.delete(np.arange(0, 30, 3))
        rec = StreamingIndex.recover(CPU, str(tmp_path))
        assert rec.content_crc() == idx.content_crc()
        assert rec.next_id == idx.next_id
        assert rec.n_live == idx.n_live
        q = db[:8]
        assert torch.equal(idx.search(q, k=4, nprobe=7)[1],
                           rec.search(q, k=4, nprobe=7)[1])

    def test_recover_after_compaction_prunes_wal(self, tmp_path):
        db, idx = _mk(directory=str(tmp_path))
        idx.insert(_rows(24))
        idx.delete(np.arange(10))
        idx.compact(reason="test")
        names = os.listdir(tmp_path)
        assert not [f for f in names if f.startswith("wal-")], \
            "commit must prune the WAL records the snapshot folded in"
        assert len([f for f in names if f.startswith("epoch-")]) <= 2
        rec = StreamingIndex.recover(CPU, str(tmp_path))
        assert rec.content_crc() == idx.content_crc()

    @pytest.mark.parametrize("point", CRASH_POINTS)
    def test_crash_sweep_recovers_consistent(self, tmp_path, point):
        """A raise-mode crash at every named protocol point: recovery
        lands on the pre- or post-mutation content (pre_journal is the
        one point where the mutation is not durable yet), twice
        alike."""
        crc_del, crc_ins2, crc_fin = chaos._sequence(str(tmp_path / "ref"))
        assert crc_fin == crc_ins2, "compaction must preserve the CRC"
        want = crc_del if point == "ingest.pre_journal" else crc_ins2
        d = str(tmp_path / "crash")
        with pytest.raises(CrashPointError):
            chaos._sequence(d, crash=point, mode="raise")
        assert StreamingIndex.recover(CPU, d).content_crc() == want
        assert StreamingIndex.recover(CPU, d).content_crc() == want

    def test_sigkill_witness(self, tmp_path):
        """A real SIGKILL at compact.mid_write (the torn-file window) in
        the port's worker, and two recoveries in a fresh process landing
        on the post-mutation content. Each process has its own
        timeout."""
        worker = os.path.join(_REPO, "tests",
                              "_torch_streaming_chaos_worker.py")
        env_ = dict(os.environ)

        def run(*args, rc=0):
            p = subprocess.run([sys.executable, worker, *args],
                               cwd=_REPO, env=env_, timeout=120,
                               capture_output=True, text=True)
            assert p.returncode == rc, p.stderr[-2000:]
            return p.stdout.split()

        _, after_insert2, final = (int(c) for c in
                                   run("--dir", str(tmp_path / "ref")))
        assert final == after_insert2
        kill_dir = str(tmp_path / "kill")
        run("--dir", kill_dir, "--crash", "compact.mid_write",
            "--mode", "kill", rc=-9)
        first, second = (int(c) for c in
                         run("--dir", kill_dir, "--recover"))
        assert first == second == after_insert2

    def test_corrupt_epoch_falls_back_to_previous(self, tmp_path):
        db, idx = _mk(directory=str(tmp_path))
        idx.insert(_rows(200))            # overflow: folds into epoch 1
        e1, crc1 = idx.epoch, idx.content_crc()
        assert e1 >= 1
        idx.delete(np.arange(0, 80))
        idx.compact(reason="test")
        e2 = idx.epoch
        assert e2 > e1
        path = idx.log.epoch_path(e2)
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            f.write(b"\xde\xad\xbe\xef" * 8)
        rec = StreamingIndex.recover(CPU, str(tmp_path))
        assert rec.epoch == e1 and rec.content_crc() == crc1
        with open(idx.log.epoch_path(e1), "r+b") as f:
            f.seek(16)
            f.write(b"\xde\xad\xbe\xef" * 8)
        with pytest.raises(RecoveryError):
            StreamingIndex.recover(CPU, str(tmp_path))

    def test_mutation_log_seq_and_prune(self, tmp_path):
        log = MutationLog(str(tmp_path))
        assert log.append({"epoch": 0, "kind": 0,
                           "data": np.arange(3)}) == 0
        assert log.append({"epoch": 1, "kind": 1,
                           "data": np.arange(2)}) == 1
        assert MutationLog(str(tmp_path)).append(
            {"epoch": 1, "kind": 0, "data": np.arange(1)}) == 2
        recs = log.wal_records()
        assert [int(r["seq"]) for r in recs] == [0, 1, 2]
        assert log.prune_wal(before_epoch=1) == 1
        assert [int(r["epoch"]) for r in log.wal_records()] == [1, 1]
        with pytest.raises(RecoveryError):
            log.load_latest_epoch()

    def test_recover_needs_a_device(self, tmp_path):
        """``res=None`` is the ``cuda:0`` handle: without CUDA, recover
        and stream_build raise instead of falling back to the host."""
        from raft_tpu_torch.core.resources import DeviceUnavailableError

        if torch.cuda.is_available():
            pytest.skip("CUDA present: cuda:0 is the default device")
        db, idx = _mk(directory=str(tmp_path))
        with pytest.raises(DeviceUnavailableError):
            StreamingIndex.recover(None, str(tmp_path))
        with pytest.raises(DeviceUnavailableError):
            stream_build(None, db, 8, max_iter=1)


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------


class TestCompaction:
    def test_compact_preserves_content_and_search_bits(self):
        db, jidx, idx = _pair(n=256)
        for ix in (idx, jidx):
            ix.insert(_rows(24))
            ix.delete(np.arange(0, 60, 2))
        crc = idx.content_crc()
        assert crc == jidx.content_crc()
        q = db[:16]
        d0, i0 = idx.search(q, k=4, nprobe=7)
        assert idx.tombstone_fraction() > 0
        idx.compact(reason="test")
        assert idx.content_crc() == crc
        assert idx.tombstone_fraction() == 0.0
        d1, i1 = idx.search(q, k=4, nprobe=7)
        assert torch.equal(d0, d1) and torch.equal(i0, i1)
        _agree((d1, i1), jidx.search(q, k=4, nprobe=7), q,
               idx.live_rows()[0])

    def test_compactor_triggers_then_settles(self):
        """``should_compact()`` equal to the reference's at every step,
        and the stated contract: a repack with slack clears both
        trigger fractions."""
        db, jidx, idx = _pair()
        c = Compactor(idx, interval=0.01, tombstone_frac=0.2, refit=False)
        jc = jst.Compactor(jidx, interval=0.01, tombstone_frac=0.2,
                           refit=False)
        assert c.should_compact() == jc.should_compact()
        assert idx.tail_full_fraction() == jidx.tail_full_fraction()
        for ix in (idx, jidx):
            ix.compact(reason="provision")
        assert c.should_compact() == jc.should_compact() is False
        for ix in (idx, jidx):
            ix.delete(np.arange(0, 80))
        assert c.should_compact() == jc.should_compact() is True
        assert c.run_once() is True and jc.run_once() is True
        assert c.compactions == 1 == jc.compactions
        assert c.should_compact() == jc.should_compact() is False
        assert c.run_once() is False, \
            "a repack with slack must clear both trigger fractions"
        assert idx.content_crc() == jidx.content_crc()

    def test_background_compactor_runs_and_stops(self):
        db, idx = _mk()
        swapped = threading.Event()
        with Compactor(idx, interval=0.01, tombstone_frac=0.2,
                       refit=False, on_change=swapped.set):
            idx.delete(np.arange(0, 80))
            assert swapped.wait(10.0), "compactor never fired"
        assert idx.tombstone_fraction() == 0.0

    def test_compactor_error_surfaces_at_stop(self, monkeypatch):
        db, idx = _mk()
        monkeypatch.setattr(idx, "compact",
                            lambda **kw: (_ for _ in ()).throw(
                                ValueError("boom")))
        c = Compactor(idx, interval=0.01, tombstone_frac=0.2,
                      refit=False)
        idx.delete(np.arange(0, 80))
        c.start()
        deadline = time.monotonic() + 10.0
        while c._error is None and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(StreamingError, match="compactor failed"):
            c.stop()

    def test_double_start_raises(self):
        db, idx = _mk()
        c = Compactor(idx, interval=60.0, refit=False)
        try:
            c.start()
            with pytest.raises(StreamingError, match="already started"):
                c.start()
        finally:
            c.stop()


# ---------------------------------------------------------------------------
# drift + refit
# ---------------------------------------------------------------------------


class TestDrift:
    def test_gauge_ratio_and_trigger(self):
        for g in (DriftGauge(threshold=1.5, alpha=1.0),
                  jst.DriftGauge(threshold=1.5, alpha=1.0)):
            assert g.ratio == 1.0 and not g.triggered
            g.set_baseline(2.0)
            assert g.observe_batch(2.0) == pytest.approx(1.0)
            assert not g.triggered
            assert g.observe_batch(4.0) == pytest.approx(2.0)
            assert g.triggered

    def test_refit_moves_centroids_and_keeps_ids(self, tmp_path):
        db, jidx, idx = _pair()
        before = n(idx.flat.centroids).copy()
        shifted = _rows(96, seed=21) + 4.0
        idx.insert(shifted)
        jidx.insert(shifted)
        epoch0 = idx.epoch
        assert idx.maybe_refit(force=True) is True
        assert jidx.maybe_refit(force=True) is True
        assert idx.epoch > epoch0
        assert not np.array_equal(before, n(idx.flat.centroids))
        np.testing.assert_allclose(n(idx.flat.centroids),
                                   np.asarray(jidx.flat.centroids),
                                   rtol=REFIT_TOL, atol=REFIT_TOL)
        rows, ids = idx.live_rows()
        assert rows.shape[0] == idx.n_live == 256
        np.testing.assert_array_equal(ids, np.arange(256))
        _, got = idx.search(shifted[:8], k=1, nprobe=idx.flat.n_lists)
        np.testing.assert_array_equal(n(got)[:, 0], np.arange(160, 168))

    def test_drift_triggered_refit_resets_baseline(self, tmp_path):
        db, idx = _mk(drift=DriftGauge(threshold=1.5, alpha=1.0),
                      directory=str(tmp_path))
        assert idx.maybe_refit() is False
        for s in range(4):
            idx.insert(_rows(48, seed=30 + s) + 6.0)
        assert idx.drift.triggered
        assert idx.maybe_refit() is True
        assert not idx.drift.triggered, \
            "refit must reset the drift baseline"
        # the journaled refit checkpoints its chunks under the journal
        assert [f for f in os.listdir(tmp_path / "refit")
                if f.startswith("kmeans_pf-")]
        rec = StreamingIndex.recover(CPU, str(tmp_path))
        assert rec.content_crc() == idx.content_crc()


# ---------------------------------------------------------------------------
# MNMG: routed ingest + rebalance
# ---------------------------------------------------------------------------


class TestMnmg:
    def test_nearest_route_matches_single_rank_bits(self):
        db, idx = _mk(n=256)
        sm = StreamingMnmg(idx, n_ranks=2)
        sm.insert(_rows(24))
        sm.delete(np.arange(0, 40, 5))
        q = db[:12]
        sd, si = idx.search(q, k=6, nprobe=7)
        md, mi = sm.search(CPU, q, k=6, nprobe=7)
        assert torch.equal(sd, md) and torch.equal(si, mi)
        sd, si = idx.search(q, k=6, nprobe=8)
        md, mi = sm.search(CPU, q, k=6, nprobe=8)
        assert torch.equal(si, mi)

    def test_load_route_placement_is_journaled(self, tmp_path):
        db, idx = _mk(n=256, directory=str(tmp_path))
        sm = StreamingMnmg(idx, n_ranks=2, route="load", slack=2.0)
        for s in range(3):
            sm.insert(_rows(32, seed=40 + s))
        sizes = n(idx.flat.sizes)
        rec = StreamingIndex.recover(CPU, str(tmp_path))
        assert rec.content_crc() == idx.content_crc()
        np.testing.assert_array_equal(sizes, n(rec.flat.sizes))
        probe = _rows(32, seed=40)
        _, got = sm.search(CPU, probe, k=1, nprobe=idx.flat.n_lists)
        np.testing.assert_array_equal(n(got)[:, 0], np.arange(256, 288))

    def test_invalid_route_rejected(self):
        db, idx = _mk()
        with pytest.raises(ValueError, match="route"):
            StreamingMnmg(idx, n_ranks=2, route="random")

    def test_rebalance_compacts_and_reshards(self):
        db, idx = _mk(n=256)
        sm = StreamingMnmg(idx, n_ranks=2)
        sm.insert(_rows(24))
        sm.delete(np.arange(0, 80))
        crc = idx.content_crc()
        epoch0 = idx.epoch
        sm.rebalance()
        assert idx.epoch > epoch0
        assert idx.content_crc() == crc
        assert int(sm.rank_loads().sum()) == idx.flat.n_db
        q = db[100:108]
        sd, si = idx.search(q, k=6, nprobe=7)
        md, mi = sm.search(CPU, q, k=6, nprobe=7)
        assert torch.equal(si, mi)


# ---------------------------------------------------------------------------
# env knobs
# ---------------------------------------------------------------------------


class TestEnvKnobs:
    @pytest.mark.parametrize("name,bad,good,parsed", [
        ("RAFT_TPU_COMPACT_TOMBSTONE_FRAC", "1.5", "0.4", 0.4),
        ("RAFT_TPU_COMPACT_INTERVAL", "-1", "0.5", 0.5),
        ("RAFT_TPU_DRIFT_THRESHOLD", "0.5", "3.0", 3.0),
    ])
    def test_registered_fail_loud(self, monkeypatch, name, bad, good,
                                  parsed):
        from raft_tpu.core import env as jenv

        monkeypatch.setenv(name, bad)
        for e in (env, jenv):
            with pytest.raises(ValueError, match=name):
                e.read(name)
        monkeypatch.setenv(name, good)
        assert env.read(name) == parsed == jenv.read(name)
        monkeypatch.delenv(name)
        assert env.read(name) == jenv.read(name)

    def test_compactor_and_gauge_read_knobs(self, monkeypatch):
        monkeypatch.setenv("RAFT_TPU_COMPACT_INTERVAL", "7.5")
        monkeypatch.setenv("RAFT_TPU_COMPACT_TOMBSTONE_FRAC", "0.45")
        monkeypatch.setenv("RAFT_TPU_DRIFT_THRESHOLD", "4.0")
        db, idx = _mk()
        c = Compactor(idx)
        assert c.interval == 7.5 and c.tombstone_frac == 0.45
        assert DriftGauge().threshold == 4.0


# ---------------------------------------------------------------------------
# the frozen epoch file and the journal's subscribers
# ---------------------------------------------------------------------------


class TestFrozenEpochFixture:
    # tests/test_durability.py's constants: the fixture's identity
    CRC = 1456153610
    N_LIVE = 108
    HORIZON = 1

    def test_fixture_recovers_forever(self, tmp_path):
        shutil.copyfile(_FIXTURE, str(tmp_path / "epoch-00000000.ckpt"))
        idx = StreamingIndex.recover(CPU, str(tmp_path))
        assert idx.content_crc() == self.CRC
        assert idx.n_live == self.N_LIVE
        assert idx._applied_seq == self.HORIZON

    def test_fixture_entries_schema(self, tmp_path):
        from raft_tpu_torch.neighbors.streaming import _epoch_entries

        ent = restore_checkpoint(_FIXTURE)
        keys = ("epoch", "next_id", "n_live", "n_db", "metric",
                "centroids", "packed_db", "packed_ids", "starts",
                "sizes", "caps", "tomb_words", "wal_horizon")
        for key in keys:
            assert key in ent, key
        # the port writes the fixture's state back with its dtypes
        shutil.copyfile(_FIXTURE, str(tmp_path / "epoch-00000000.ckpt"))
        out = _epoch_entries(StreamingIndex.recover(CPU, str(tmp_path)))
        for key in keys:
            assert np.asarray(out[key]).dtype == \
                np.asarray(ent[key]).dtype, key


class TestJournal:
    def test_truncate_from_rewinds_journal(self, tmp_path):
        log = MutationLog(str(tmp_path / "j"))
        for i in range(5):
            log.append({"kind": 1, "i": i})
        assert log.truncate_from(3) == 2
        assert [int(r["seq"]) for r in log.wal_records()] == [0, 1, 2]
        assert log.append({"kind": 1, "i": 99}) == 3
        assert log.truncate_from(100) == 0

    def test_multi_subscriber_order_and_removal(self, tmp_path):
        log = MutationLog(str(tmp_path / "j"))
        calls = []
        a = lambda rec: calls.append(("a", int(rec["seq"])))  # noqa: E731
        b = lambda rec: calls.append(("b", int(rec["seq"])))  # noqa: E731
        log.add_on_append(a)
        log.add_on_append(b)
        log.add_on_append(a)
        log.append({"kind": 1})
        assert calls == [("a", 0), ("b", 0)]
        log.remove_on_append(a)
        log.append({"kind": 1})
        assert calls[-1] == ("b", 1)
        log.remove_on_append(a)

    def test_legacy_single_slot_shim(self, tmp_path):
        log = MutationLog(str(tmp_path / "j"))
        assert log.on_append is None
        a = lambda rec: None  # noqa: E731
        b = lambda rec: None  # noqa: E731
        log.on_append = a
        assert log.on_append is a
        log.add_on_append(b)
        assert log.on_append == (a, b)
        log.on_append = b
        assert log.on_append is b
        log.on_append = None
        assert log.on_append is None


# ---------------------------------------------------------------------------
# the two packages on one journal
# ---------------------------------------------------------------------------


class TestCrossPackage:
    def test_port_recovers_reference_journal(self, tmp_path):
        db = _db()
        d = str(tmp_path / "ref")
        jidx = jst.stream_build(None, db, 8, seed=0, max_iter=4,
                                directory=d)
        jidx.insert(_rows(24))
        jidx.insert(_rows(200, seed=13))         # overflow: an epoch
        jidx.delete(np.arange(0, 60, 3))
        jidx.insert(_rows(4, seed=17))
        rec = StreamingIndex.recover(CPU, d)
        assert rec.content_crc() == jidx.content_crc()
        assert rec.n_live == jidx.n_live and rec.next_id == jidx.next_id
        q = db[:16]
        _agree(rec.search(q, k=4, nprobe=7), jidx.search(q, k=4, nprobe=7),
               q, rec.live_rows()[0])

    def test_one_sequence_same_files_each_step(self, tmp_path):
        """Insert, overflowing insert, delete, compaction on both
        packages: the same CRC, byte-identical WAL and epoch files and
        the same search ids after each step."""
        db, jidx, idx = _pair(tmp_path)
        q = db[:16]
        steps = [lambda ix: ix.insert(_rows(12)),
                 lambda ix: ix.insert(_rows(200, seed=13)),
                 lambda ix: ix.delete(np.arange(0, 90, 3)),
                 lambda ix: ix.compact(reason="test")]
        assert _files(tmp_path / "ref") == _files(tmp_path / "port")
        for step in steps:
            step(jidx)
            step(idx)
            assert idx.content_crc() == jidx.content_crc()
            assert idx.epoch == jidx.epoch
            assert _files(tmp_path / "ref") == _files(tmp_path / "port")
            _agree(idx.search(q, k=5, nprobe=7),
                   jidx.search(q, k=5, nprobe=7), q, idx.live_rows()[0])

    def test_reference_recovers_port_journal(self, tmp_path):
        db, idx = _mk(directory=str(tmp_path))
        idx.insert(_rows(24))
        idx.insert(_rows(200, seed=13))
        idx.delete(np.arange(0, 60, 3))
        idx.insert(_rows(4, seed=17))
        rec = jst.StreamingIndex.recover(None, str(tmp_path))
        assert rec.content_crc() == idx.content_crc()
        assert rec.n_live == idx.n_live

    def test_streaming_index_from_entries(self, tmp_path):
        from raft_tpu_torch.interop import streaming_index_from_entries

        db = _db()
        jidx = jst.stream_build(None, db, 8, seed=0, max_iter=4)
        jidx.insert(_rows(24))
        jidx.delete(np.arange(0, 40, 4))
        idx = streaming_index_from_entries(jst._epoch_entries(jidx), CPU)
        assert idx.content_crc() == jidx.content_crc()
        q = db[:16]
        _agree(idx.search(q, k=4, nprobe=7), jidx.search(q, k=4, nprobe=7),
               q, idx.live_rows()[0])
        # journaled: the state lands as an epoch the reference recovers
        log = MutationLog(str(tmp_path / "j"))
        idx2 = streaming_index_from_entries(jst._epoch_entries(jidx), CPU,
                                            log=log)
        idx2.insert(_rows(3, seed=19))
        rec = jst.StreamingIndex.recover(None, str(tmp_path / "j"))
        assert rec.content_crc() == idx2.content_crc()

    def test_bf16_journal_crosses_packages(self, tmp_path):
        """A bf16 database's journal (rows in the reference's bf16 wire
        form): the port recovers the reference's directory, then keeps
        journaling into it, and the reference recovers the result; the
        CRC (over the raw bf16 bytes) is equal at each hand-over."""
        import jax.numpy as jnp

        db = _db()
        c = db[:8].copy()
        d = str(tmp_path / "j")
        jflat = jivf.build(None, jnp.asarray(db, jnp.bfloat16), 8,
                           centroids=c)
        jidx = jst.StreamingIndex(jflat, log=jst.MutationLog(d))
        with jidx._lock:
            jidx._write_epoch_locked(crash=False)
        jidx.insert(jnp.asarray(_rows(12), jnp.bfloat16))
        jidx.delete(np.arange(0, 30, 3))
        idx = StreamingIndex.recover(CPU, d)
        assert idx.flat.packed_db.dtype == torch.bfloat16
        assert idx.content_crc() == jidx.content_crc()
        idx.insert(torch.from_numpy(_rows(200, seed=13)).to(torch.bfloat16))
        idx.insert(torch.from_numpy(_rows(4, seed=17)).to(torch.bfloat16))
        assert jst.StreamingIndex.recover(None, d).content_crc() == \
            idx.content_crc()
