"""The port's peak table (``core/hw``), performance attribution
(``obs/perf``), export renderers (``obs/export``) and schema validators
(``obs/schema``) against the reference package's, on the CPU.

The card's name is faked where detection reads it. The port's JSONL
records and chrome trace must pass the reference's own
``raft_tpu.obs.schema`` validators as well as the port's.
"""

import json

import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu.core import hw as jhw
from raft_tpu.obs import metrics as jmetrics
from raft_tpu.obs import perf as jperf
from raft_tpu.obs import schema as jschema
from raft_tpu_torch import obs
from raft_tpu_torch.core import hw
from raft_tpu_torch.core.guards import ConvergenceReport
from raft_tpu_torch.obs import metrics as obs_metrics
from raft_tpu_torch.obs import perf, schema
from raft_tpu_torch.obs.spans import set_retention


@pytest.fixture
def perf_on():
    prev, jprev = perf.set_perf_enabled(True), jperf.set_perf_enabled(True)
    for p in (perf, jperf):
        p.clear_perf_profiles()
        p.reset_peaks()
    try:
        yield
    finally:
        perf.set_perf_enabled(prev)
        jperf.set_perf_enabled(jprev)
        for p in (perf, jperf):
            p.clear_perf_profiles()
            p.reset_peaks()


@pytest.fixture
def live_obs():
    """Metrics on in both packages, fresh registries, clean rings."""
    saved = []
    for o, m in ((obs, obs_metrics), (jobs, jmetrics)):
        saved.append((o, m, o.enabled(), m.set_registry(o.MetricsRegistry()),
                      o.set_sink(None)))
        o.set_enabled(True)
        o.clear_spans()
        o.clear_events()
        o.set_sample_rate(1.0)
    try:
        yield obs_metrics.get_registry()
    finally:
        for o, m, was, reg, sink in saved:
            o.set_enabled(was)
            m.set_registry(reg)
            o.set_sink(sink)
            o.clear_spans()
            o.clear_events()
            o.set_sample_rate(1.0)
        set_retention(2048)


# -- core/hw -----------------------------------------------------------------


class TestHwPeaks:
    def test_backend_tables_are_the_references(self):
        assert (hw.CPU_PEAKS.flops_per_s, hw.CPU_PEAKS.bytes_per_s) \
            == (jhw.CPU_PEAKS.flops_per_s, jhw.CPU_PEAKS.bytes_per_s)
        assert (hw.GPU_PEAKS.flops_per_s, hw.GPU_PEAKS.bytes_per_s) \
            == (jhw.GPU_PEAKS.flops_per_s, jhw.GPU_PEAKS.bytes_per_s)
        for table, ref in ((hw.SUSTAINED_FLOP_S, jhw.SUSTAINED_FLOP_S),
                           (hw.SUSTAINED_BYTES_S, jhw.SUSTAINED_BYTES_S)):
            assert table == {k: v for k, v in ref.items() if k != "tpu"}
        assert not hasattr(hw, "TPU_PEAKS")
        for backend in ("cpu", "gpu"):
            got, want = hw.peaks(backend=backend), jhw.peaks(backend=backend)
            assert (got.flops_per_s, got.bytes_per_s, got.source) \
                == (want.flops_per_s, want.bytes_per_s, want.source)
        assert hw.peaks("cpu") == hw.CPU_PEAKS
        assert hw.peaks(backend="weird").source == "fallback"

    @pytest.mark.parametrize("name,flops,bytes_", [
        ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12),
        ("NVIDIA H100 SXM5 80GB", 989e12, 3.35e12),
        ("NVIDIA A100-SXM4-80GB", 5e13, 1e12),
        ("NVIDIA H100 PCIe", 5e13, 1e12),
    ])
    def test_card_detection_by_name(self, monkeypatch, name, flops, bytes_):
        monkeypatch.setattr(hw, "_cuda_name", lambda dev: name)
        pk = hw.peaks("cuda:0")
        assert (pk.flops_per_s, pk.bytes_per_s, pk.source) \
            == (flops, bytes_, "table")

    def test_env_override(self, monkeypatch):
        monkeypatch.setenv("RAFT_TPU_PERF_PEAKS", "flops=1e12")
        pk = hw.peaks(backend="cpu")
        assert (pk.flops_per_s, pk.bytes_per_s, pk.source) \
            == (1e12, hw.CPU_PEAKS.bytes_per_s, "env")
        monkeypatch.setenv("RAFT_TPU_PERF_PEAKS", "flops=2e14,bytes=3e12")
        pk = hw.peaks(backend="gpu")
        want = jhw.peaks(backend="gpu")
        assert (pk.flops_per_s, pk.bytes_per_s, pk.source) \
            == (want.flops_per_s, want.bytes_per_s, want.source) \
            == (2e14, 3e12, "env")

    @pytest.mark.parametrize("bad", ["flops=", "flops=-1", "speed=3",
                                     "bytes=abc", ","])
    def test_malformed_override_raises(self, monkeypatch, bad):
        monkeypatch.setenv("RAFT_TPU_PERF_PEAKS", bad)
        with pytest.raises(ValueError, match="RAFT_TPU_PERF_PEAKS"):
            hw.peaks(backend="cpu")
        with pytest.raises(ValueError, match="RAFT_TPU_PERF_PEAKS"):
            jhw.peaks(backend="cpu")


# -- obs/perf ----------------------------------------------------------------


class TestPerf:
    def test_off_is_noop(self):
        assert not perf.perf_enabled()
        assert perf.profile_executable("op", 8, model_flops=1.0) is None
        assert perf.record_launch("op", 8, 1.0) is None
        assert perf.record_hbm_watermark("cpu") is None
        assert perf.perf_profiles() == {}
        snap = perf.perf_snapshot()
        assert set(snap) == set(jperf.perf_snapshot())
        assert snap["enabled"] is False and snap["profiles"] == {}
        with perf.profile_session() as d:
            assert d is None

    @pytest.mark.parametrize("flops,bytes_,wall,steps", [
        (2.5e10, 1e9, 1.0, 1.0), (1e9, 1.5e10, 1.0, 1.0),
        (1e6, 1e6, 1.0, 1.0), (1e9, 0.0, 1.0, 10.0), (3e9, 2e9, 0.25, 4.0)])
    def test_launch_attribution_is_the_references(self, perf_on, flops,
                                                  bytes_, wall, steps):
        """CPU peaks in both: the same achieved rates, roofline fraction
        and bound for the same model costs and wall."""
        got = perf.profile_executable("op", "chunk", model_flops=flops,
                                      model_bytes=bytes_, tag=1)
        assert got.source == "model"
        jperf.profile_executable("op", "chunk", model_flops=flops,
                                 model_bytes=bytes_, tag=1)
        # the reference on a CPU backend; the port's peaks from its CPU row
        perf._peaks = hw.CPU_PEAKS
        p = perf.record_launch("op", "chunk", wall, steps=steps)
        j = jperf.record_launch("op", "chunk", wall, steps=steps)
        assert (p.achieved_flops_per_s, p.achieved_bytes_per_s,
                p.roofline_frac, p.bound, p.steps, p.launches) \
            == (j.achieved_flops_per_s, j.achieved_bytes_per_s,
                j.roofline_frac, j.bound, j.steps, j.launches)
        assert p.as_dict() == j.as_dict()
        assert perf.record_launch("ghost", 8, 0.5) is None
        assert perf.record_launch("op", "chunk", 0.0) is None

    def test_cost_analysis_pair_keeps_the_model(self, perf_on):
        prof = perf.profile_executable("op", 4, fn=lambda a: a * 2,
                                       example=(np.ones(3),),
                                       model_flops=5.0, model_bytes=7.0)
        assert (prof.flops, prof.bytes, prof.source) == (5.0, 7.0, "model")

    def test_gauges_and_hbm_watermark(self, perf_on, live_obs):
        perf._peaks = hw.CPU_PEAKS
        perf.profile_executable("op", 8, model_flops=2.5e10,
                                model_bytes=1e9)
        perf.record_launch("op", 8, 1.0)
        snap = live_obs.snapshot()
        series = snap["perf_roofline_frac"]["series"]
        assert series[0]["labels"] == {"op": "op", "bucket": "8",
                                       "bound": "compute"}
        assert series[0]["value"] == pytest.approx(0.5)
        stats = perf.record_hbm_watermark("cpu")
        assert stats == {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                         "bytes_limit": 0}
        assert perf.perf_snapshot()["hbm"]["polls"] == 1
        assert "perf_hbm_bytes_in_use" in live_obs.snapshot()

    def test_snapshot_perf_section(self, perf_on):
        perf._peaks = hw.CPU_PEAKS
        perf.profile_executable("cluster.kmeans_fit", "chunk",
                                model_flops=1e9, model_bytes=1e8)
        snap = perf.perf_snapshot()
        assert snap["enabled"] and snap["peaks"]["name"] == "cpu"
        assert set(snap) == set(jperf.perf_snapshot())
        assert list(snap["profiles"]) == ["cluster.kmeans_fit[chunk]"]

    def test_profile_session_span(self, perf_on, live_obs, tmp_path):
        with perf.profile_session(str(tmp_path)) as d:
            torch.ones(8).sum()
        assert d == str(tmp_path)
        assert (tmp_path / "trace.json").exists()
        recs = obs.spans("perf.profile_session")
        assert len(recs) == 1 and recs[0]["attrs"]["captured"] is True
        assert recs[0]["duration"] >= 0.0

    def test_chunk_driver_feeds_the_profile(self, perf_on):
        from raft_tpu_torch.runtime import compiled_driver as cd

        cd.run_chunked(lambda c, s: cd.chunk_while(
            lambda c: (c + 1, False), c, s), torch.tensor(0), max_steps=6,
            sync_every=3, op="test.perf", step_flops=1e6, step_bytes=1e6)
        prof = perf.perf_profiles()[("test.perf", "chunk")]
        assert prof.launches == 2 and prof.steps == 6.0
        assert perf.perf_snapshot()["hbm"]["polls"] == 2


# -- obs/metrics, spans, export ---------------------------------------------


def _drive_metrics(o):
    o.inc("requests_total", 2, help="requests", op="a")
    o.inc("requests_total", 1, help="requests", op="b\"q")
    o.set_gauge("depth", 3.5, help="queue depth")
    for v in (1e-4, 0.02, 3.0):
        o.observe("latency_seconds", v, help="latency", op="a")
    o.record_convergence("cluster.kmeans_fit", ConvergenceReport(
        converged=False, n_iter=12, residual=3e-7, tol=1e-9))


def test_residual_buckets_and_convergence(live_obs):
    assert obs.RESIDUAL_BUCKETS == jobs.RESIDUAL_BUCKETS
    _drive_metrics(obs)
    snap = live_obs.snapshot()
    assert snap["solver_iterations_total"]["series"][0]["value"] == 12
    assert snap["solver_runs_total"]["series"][0]["labels"] == {
        "solver": "cluster.kmeans_fit", "converged": "false"}
    assert snap["solver_residual"]["series"][0]["count"] == 1


def test_prometheus_text_is_the_references(live_obs):
    _drive_metrics(obs)
    _drive_metrics(jobs)
    text = obs.render_prometheus()
    assert text == jobs.render_prometheus()
    assert '# TYPE latency_seconds histogram' in text
    assert 'requests_total{op="b\\"q"} 1' in text


def test_snapshot_keys_are_the_references(live_obs):
    _drive_metrics(obs)
    _drive_metrics(jobs)
    got, want = obs.snapshot(), jobs.snapshot()
    assert set(got) == set(want)
    assert got["metrics"] == want["metrics"]
    assert got["perf"]["enabled"] is False


def test_jsonl_and_chrome_trace_pass_both_validators(live_obs, tmp_path):
    from raft_tpu_torch.core import trace

    path = tmp_path / "stream.jsonl"
    sink = obs.JsonlSink(str(path))
    obs.set_sink(sink)
    with obs.span("outer", rows=3):
        with obs.span("cluster.kmeans_fit.chunk", steps=4) as sp:
            sp.set_attr(ran=4)
        trace.record_event("compiled_driver.chunk", op="x", steps=4,
                           done=False, arr=np.float32(2.0))
    obs.record_span("manufactured", t_start=1.0, duration=0.5, tag="m")
    sink.close()
    obs.set_sink(None)
    for validate in (schema.validate_jsonl, jschema.validate_jsonl):
        n_ok, problems = validate(str(path))
        assert problems == [] and n_ok == 4
    kinds = [json.loads(line)["kind"] for line in path.read_text()
             .splitlines()]
    assert sorted(kinds) == ["event", "span", "span", "span"]
    doc = obs.render_chrome_trace(str(tmp_path / "trace.json"))
    assert schema.validate_chrome_trace(doc) == []
    assert jschema.validate_chrome_trace(doc) == []
    phases = [e["ph"] for e in doc["traceEvents"]]
    assert phases.count("X") == 3 and phases.count("b") == 1
    assert json.loads((tmp_path / "trace.json").read_text()) == doc
    assert jschema.validate_chrome_trace({"traceEvents": [{}]}) \
        == schema.validate_chrome_trace({"traceEvents": [{}]})


def test_record_span_off_is_noop():
    assert not obs.enabled()
    assert obs.record_span("x", t_start=0.0, duration=1.0) is None


def test_schema_validators_are_the_references(tmp_path):
    records = [
        {"kind": "event", "name": "e", "ts": 1.0, "t": 2.0, "range": None,
         "range_stack": []},
        {"kind": "span", "name": "s", "ts": 1.0, "t": 2.0, "duration": -1,
         "parent": None, "thread": 1, "attrs": {}},
        {"kind": "flight", "ts": 1.0, "t": 2.0, "error_type": "E",
         "error": "x", "n_spans": 0, "n_events": 1, "op": None},
        {"kind": "metrics", "ts": 1.0, "t": 2.0, "metrics": {}},
        {"kind": "bogus"}, [], {"kind": "event", "name": "", "ts": "x"},
    ]
    for rec in records:
        assert schema.validate_record(rec) == jschema.validate_record(rec)
    path = tmp_path / "bundle.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in records[2:4]) + "\n")
    assert schema.validate_flight_bundle(str(path)) \
        == jschema.validate_flight_bundle(str(path)) == (2, [])
    path.write_text("not json\n" + json.dumps(records[3]) + "\n")
    assert schema.validate_flight_bundle(str(path)) \
        == jschema.validate_flight_bundle(str(path))
