"""Tests of the benchmark's harness. They run on the CPU at small sizes
(``python -m pytest portbench/tests`` from the repository's root); the
tests marked ``cuda`` need a card and skip without one."""

import copy
import time

import pytest
import torch

from portbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")

# the cells at sizes a CPU test can hold: the published widths, few rows
TINY = {
    "sift1m-flat.batch": {
        "config": {"n_base": 4096},
        "traffic": {"query_set": 256, "rows_per_call": 128}},
    "sift1m-ivf1024.batch": {
        "config": {"n_base": 16384, "n_lists": 128, "nprobe": 8},
        "traffic": {"query_set": 256, "rows_per_call": 64}},
    "sift1m-kmeans1024.fit": {
        "config": {"n_base": 16384, "n_clusters": 128}},
}


def run_tiny(cell, seed=2**31 + 17, seconds=0.5, traced=False, tier=None):
    """One run of ``cell`` on the CPU at its tiny size."""
    return harness.run(cell, seed, seconds, traced, t_start=time.monotonic(),
                       require_card=False, device="cpu", tier=tier,
                       bench=BENCH,
                       overrides=copy.deepcopy(TINY[cell]))


@pytest.fixture
def card():
    """The first CUDA card; skips the test without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
