"""The result's last line, from whole runs of each cell at a tiny size
on the CPU, and the command's refusal without a card."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import BENCH, TINY, run_tiny

CELLS = sorted(TINY)


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_gives_the_last_line_schema(cell, traced):
    out = run_tiny(cell, traced=traced)
    line = json.loads(json.dumps(out.result))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        br = line["breakdown"]
        assert len(br["device_ops"]) <= 10 and len(br["idle_gaps"]) <= 10
        allowed = {m["name"] for m in harness.per_layer_for(BENCH, cell)}
        assert set(line["metrics"]) <= allowed
    else:
        want = {m["name"] for m in harness.end_to_end_for(BENCH, cell)}
        assert set(line["metrics"]) == want
        for m in line["metrics"].values():
            assert m["value"] > 0 and isinstance(m["unit"], str)


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "sift1m-flat.batch", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_the_command_fails_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's
    folder, the run cannot find the program and prints no result."""
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "sift1m-flat.batch", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
