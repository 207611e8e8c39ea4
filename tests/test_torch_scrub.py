"""The port's scrubber (``raft_tpu_torch.neighbors.scrub``) against the
reference's ``raft_tpu.neighbors.scrub`` on the CPU:
``tests/test_durability.py``'s ``TestScrub`` cases and its knobs
(``RAFT_TPU_SCRUB_INTERVAL``, ``RAFT_TPU_WAL_RETAIN``).

Both packages journal one database under the reference's centroids, so
their files are byte-identical and a corruption at one offset damages
the same entry. Tolerances: exact throughout (reports, CRCs, counters).
"""

import os
import shutil
import time

import numpy as np
import pytest
import torch

from raft_tpu.comms.faults import FaultInjector as JFaultInjector
from raft_tpu.neighbors import scrub as jscrub
from raft_tpu.neighbors import streaming as jst
from raft_tpu_torch import device_resources, obs
from raft_tpu_torch.comms.faults import FaultInjector
from raft_tpu_torch.core import env
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.neighbors.scrub import Scrubber
from raft_tpu_torch.neighbors.streaming import (MutationLog, ShardCorruptError,
                                                StreamingIndex, _epoch_entries,
                                                stream_build)
from raft_tpu_torch.obs import metrics as obs_metrics

CPU = device_resources("cpu")
N, D, L = 160, 8, 8


def _rows(rng, m=12):
    return rng.normal(size=(m, D)).astype(np.float32)


def _leader(tmp_path, seed=3):
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(N, D)).astype(np.float32)
    idx = stream_build(CPU, db, L, seed=0, max_iter=4,
                       directory=str(tmp_path / "leader"))
    return idx, rng


def _pair(tmp_path, seed=3):
    """The reference's journaled index and the port's over the same rows
    and centroids, and one generator for both packages' next rows."""
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(N, D)).astype(np.float32)
    jidx = jst.stream_build(None, db, L, seed=0, max_iter=4,
                            directory=str(tmp_path / "ref"))
    c = np.array(jidx.flat.centroids)
    flat = ivf_flat.build(CPU, torch.from_numpy(db), L,
                          centroids=torch.from_numpy(c))
    idx = StreamingIndex(flat, log=MutationLog(str(tmp_path / "port")),
                         res=CPU)
    with idx._lock:
        idx._write_epoch_locked(crash=False)
    return jidx, idx, rng


def _same(rep, jrep):
    assert (rep.files_checked, rep.corrupt, rep.repaired, rep.quarantined,
            rep.memory_repaired) == \
        (jrep.files_checked, jrep.corrupt, jrep.repaired, jrep.quarantined,
         jrep.memory_repaired)


@pytest.fixture
def live_obs():
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


class TestScrub:
    def test_clean_pass_counts_files(self, tmp_path, live_obs):
        jidx, idx, rng = _pair(tmp_path)
        rows = _rows(rng)
        idx.insert(rows)
        jidx.insert(rows)
        rep = Scrubber(idx, interval=10.0).run_once()
        assert rep.files_checked >= 2           # epoch(s) + WAL record
        assert not rep.corrupt and not rep.quarantined
        assert _counter(live_obs, "scrub_passes_total") == 1
        _same(rep, jscrub.Scrubber(jidx, interval=10.0).run_once())

    def test_corrupt_epoch_quarantined_and_repaired(self, tmp_path,
                                                    live_obs):
        jidx, idx, rng = _pair(tmp_path)
        rows = _rows(rng)
        idx.insert(rows)
        jidx.insert(rows)
        crc = idx.content_crc()
        newest = idx.log.epoch_path(max(idx.log.epoch_steps()))
        FaultInjector().corrupt_bytes(newest)
        JFaultInjector().corrupt_bytes(
            jidx.log.epoch_path(max(jidx.log.epoch_steps())))
        sc = Scrubber(idx, interval=10.0)
        rep = sc.run_once()
        name = os.path.basename(newest)
        assert rep.corrupt == [name]
        assert rep.quarantined == [name]
        assert rep.repaired == [name]           # rewritten from memory
        assert os.path.exists(newest + ".quarantined")
        _same(rep, jscrub.Scrubber(jidx, interval=10.0).run_once())
        rep2 = sc.run_once()
        assert not rep2.corrupt
        recovered = StreamingIndex.recover(CPU, idx.log.directory)
        assert recovered.content_crc() == crc
        fam = live_obs.snapshot()["scrub_corruptions_total"]
        outcomes = {s["labels"]["outcome"]: s["value"]
                    for s in fam["series"]}
        assert outcomes == {"repaired": 1.0}
        # the two packages' repaired journals are the same bytes
        for f in sorted(os.listdir(idx.log.directory)):
            with open(os.path.join(idx.log.directory, f), "rb") as a, \
                    open(os.path.join(jidx.log.directory, f), "rb") as b:
                assert a.read() == b.read(), f

    def test_corrupt_wal_superseded_by_epoch_rewrite(self, tmp_path):
        leader, rng = _leader(tmp_path)
        ids = leader.insert(_rows(rng))
        leader.delete(ids[:3])                  # in place -> WAL record
        crc = leader.content_crc()
        wal = [os.path.join(leader.log.directory, f)
               for f in sorted(os.listdir(leader.log.directory))
               if f.startswith("wal-")]
        assert wal
        FaultInjector().corrupt_bytes(wal[-1])
        rep = Scrubber(leader, interval=10.0).run_once()
        assert rep.repaired
        recovered = StreamingIndex.recover(CPU, leader.log.directory)
        assert recovered.content_crc() == crc

    def test_cold_directory_repairs_from_source(self, tmp_path):
        leader, rng = _leader(tmp_path)
        leader.insert(_rows(rng))
        crc = leader.content_crc()
        cold = str(tmp_path / "cold")
        shutil.copytree(leader.log.directory, cold)
        log = MutationLog(cold)
        faults = FaultInjector()
        for step in log.epoch_steps():
            faults.corrupt_bytes(log.epoch_path(step))
        for f in sorted(os.listdir(cold)):
            if f.startswith("wal-"):
                faults.corrupt_bytes(os.path.join(cold, f))
        sc = Scrubber(log=log,
                      repair_source=lambda: _epoch_entries(leader),
                      interval=10.0)
        rep = sc.run_once()
        assert rep.quarantined and rep.repaired
        recovered = StreamingIndex.recover(CPU, cold)
        assert recovered.content_crc() == crc
        # the reference recovers the directory the port repaired
        assert jst.StreamingIndex.recover(None, cold).content_crc() == crc

    def test_cold_directory_unrepairable_raises_typed(self, tmp_path):
        leader, rng = _leader(tmp_path)
        log = MutationLog(str(tmp_path / "dead"))
        log.write_epoch(0, _epoch_entries(leader))
        FaultInjector().corrupt_bytes(log.epoch_path(0))
        sc = Scrubber(log=log, interval=10.0)
        with pytest.raises(ShardCorruptError) as ei:
            sc.run_once()
        assert "epoch-00000000" in ei.value.shard
        assert os.path.exists(log.epoch_path(0) + ".quarantined")

    def test_memory_sidecar_detects_ram_damage(self, tmp_path):
        leader, rng = _leader(tmp_path)
        sc = Scrubber(leader, interval=10.0)
        sc.run_once()                           # baseline sidecar
        leader._tomb_host[0] ^= np.uint32(1)
        with pytest.raises(ShardCorruptError, match="memory"):
            sc.run_once()

    def test_memory_sidecar_repairs_from_source(self, tmp_path,
                                                live_obs):
        leader, rng = _leader(tmp_path)
        healthy = _epoch_entries(leader)
        crc = leader.content_crc()
        sc = Scrubber(leader, repair_source=lambda: dict(healthy),
                      interval=10.0)
        sc.run_once()
        leader._tomb_host[0] ^= np.uint32(1)
        rep = sc.run_once()
        assert rep.memory_repaired
        assert leader.content_crc() == crc
        assert _counter(live_obs, "scrub_memory_repairs_total") == 1

    def test_memory_sidecar_catches_a_packed_byte(self, tmp_path):
        """One byte of the packed rows flipped in place (the damage the
        card's run injects on the device) is caught and repaired from
        the source; the snapshot's search is the healthy one again."""
        leader, rng = _leader(tmp_path)
        healthy = _epoch_entries(leader)
        q = torch.from_numpy(_rows(rng, 4))
        want = leader.search(q, 4, 7)
        sc = Scrubber(leader, repair_source=lambda: dict(healthy),
                      interval=10.0)
        sc.run_once()
        raw = leader.snapshot.flat.packed_db.view(torch.uint8).view(-1)
        raw[raw.numel() // 2] ^= 0xFF
        assert sc.run_once().memory_repaired
        got = leader.search(q, 4, 7)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                            want[1])

    def test_background_thread_scrubs_on_interval(self, tmp_path):
        leader, rng = _leader(tmp_path)
        sc = Scrubber(leader, interval=0.02)
        with sc:
            deadline = time.monotonic() + 5.0
            while sc.passes < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
        assert sc.passes >= 2

    def test_validation(self, tmp_path):
        leader, rng = _leader(tmp_path)
        with pytest.raises(ValueError, match="journal"):
            Scrubber()
        with pytest.raises(ValueError, match="not both"):
            Scrubber(leader, log=MutationLog(str(tmp_path / "other")))
        with pytest.raises(ValueError, match="interval"):
            Scrubber(leader, interval=0.0)


class TestEnvKnobs:
    @pytest.mark.parametrize("name,bad,good,parsed", [
        ("RAFT_TPU_WAL_RETAIN", "0", "3", 3),
        ("RAFT_TPU_WAL_RETAIN", "two", "2", 2),
        ("RAFT_TPU_SCRUB_INTERVAL", "-1", "0.5", 0.5),
        ("RAFT_TPU_SCRUB_INTERVAL", "fast", "2.0", 2.0),
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

    def test_retain_knob_drives_wal_pruning(self, tmp_path, monkeypatch):
        monkeypatch.setenv("RAFT_TPU_WAL_RETAIN", "4")
        log = MutationLog(str(tmp_path / "j"))
        assert log.retain == 4
        assert MutationLog(str(tmp_path / "k"), retain=1).retain == 1
        monkeypatch.setenv("RAFT_TPU_WAL_RETAIN", "-2")
        with pytest.raises(ValueError, match="RAFT_TPU_WAL_RETAIN"):
            MutationLog(str(tmp_path / "m"))

    def test_scrub_interval_knob(self, tmp_path, monkeypatch):
        leader, rng = _leader(tmp_path)
        monkeypatch.setenv("RAFT_TPU_SCRUB_INTERVAL", "7.5")
        assert Scrubber(leader).interval == 7.5
