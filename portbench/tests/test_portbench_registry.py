"""Cells, configurations, mixes, drivers and metric readers are found
by name, from the files alone."""

import json
import shutil
from pathlib import Path

import pytest

from portbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


def test_the_tests_cover_every_cell():
    from portbench.tests.conftest import TINY

    assert {w["name"] for w in BENCH["workloads"]} == set(TINY)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    found, entry = harness.find_cell(BENCH, cell, 1, "cpu")
    assert found.name == cell and entry["name"] == cell
    assert harness.load_driver(found.workload["driver"]) is not None
    assert "limits" in found.workload
    assert harness.end_to_end_for(BENCH, cell)
    assert harness.per_layer_for(BENCH, cell)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_reader_loads(metric):
    assert callable(harness.load_reader(metric))


def test_each_cell_reports_setup_and_another_metric():
    for w in BENCH["workloads"]:
        names = {m["name"] for m in harness.end_to_end_for(BENCH, w["name"])}
        assert "setup_s" in names and len(names) >= 2


def test_a_new_cell_mix_and_metric_are_found_from_data_alone(tmp_path):
    """Copy the benchmark's folder, add one of each as new files only,
    and find them by name."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench_dir = root / "portbench"
    (bench_dir / "traffic" / "batch-512.json").write_text(json.dumps(
        {"loop": "closed", "input": "queries", "query_set": 10000,
         "rows_per_call": 512}))
    (bench_dir / "workloads" / "sift1m-flat.batch512.json").write_text(
        json.dumps({"driver": "knn_batch", "limits": {"dist_gap": 1}}))
    (bench_dir / "metrics" / "knn.calls.py").write_text(
        "def read(r):\n    return float(r.window.counts['calls'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "sift1m-flat.batch512",
                               "config": "sift1m-flat",
                               "traffic": "batch-512", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "knn.calls", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "exact search", "moves": "qps",
                               "workloads": ["sift1m-flat.batch512"]})
    cell, _ = harness.find_cell(bench, "sift1m-flat.batch512", 3, "cpu",
                                bench_dir)
    assert cell.traffic["rows_per_call"] == 512
    assert cell.config["name"] == "sift1m-flat"
    assert [m["name"] for m in harness.per_layer_for(
        bench, "sift1m-flat.batch512")] == ["knn.calls"]
    read = harness.load_reader("knn.calls", bench_dir)

    class W:
        counts = {"calls": 7}

    class R:
        window = W

    assert read(R) == 7.0


def test_per_layer_metrics_without_workloads_follow_their_moves():
    bench = {"end_to_end": [{"name": "qps", "workloads": ["a"]},
                            {"name": "setup_s"}],
             "per_layer": [{"name": "x", "moves": "qps"},
                           {"name": "y", "moves": "setup_s"},
                           {"name": "z", "moves": "qps",
                            "workloads": ["b"]}]}
    assert [m["name"] for m in harness.per_layer_for(bench, "a")] == \
        ["x", "y"]
    assert [m["name"] for m in harness.per_layer_for(bench, "b")] == \
        ["y", "z"]


def test_file_names_and_entries_keep_the_contract():
    import re

    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert name.match(e["name"]), e["name"]
    for w in BENCH["workloads"]:
        assert name.match(w["traffic"]) and len(w["why"]) <= 200
    for path in harness.BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(harness.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
    assert Path(harness.ROOT / "BENCHMARK.json").stat().st_size < 64 * 1024
