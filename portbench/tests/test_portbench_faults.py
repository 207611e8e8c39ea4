"""Whole runs at a tiny size on the CPU with the timed path broken
underneath (``portbench.faults``): each fault a cell can have, as its
driver names them, has to come out not correct. The cells run on one
card, so no exchange between cards can be left out."""

import pytest

from portbench import faults, harness
from portbench.tests.conftest import BENCH, TINY, run_tiny


def _driver(cell):
    found, _ = harness.find_cell(BENCH, cell, 1, "cpu")
    return harness.load_driver(found.workload["driver"])


CASES = [(cell, fault) for cell in sorted(TINY)
         for fault in sorted(_driver(cell).FAULTS)]


def test_every_cell_has_its_faults():
    assert {c for c, _ in CASES} == set(TINY)
    assert {f for c, f in CASES if c == "sift1m-ivf1024.batch"} >= \
        {"altered", "half", "build_unchanged", "build_half"}


def test_an_unknown_fault_is_refused():
    with pytest.raises(ValueError, match="no fault"):
        faults.plant(_driver("sift1m-flat.batch"), "unchanged")


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f}" for c, f in CASES])
def test_a_planted_fault_fails(cell, fault):
    undo = faults.plant(_driver(cell), fault)
    try:
        out = run_tiny(cell)
    finally:
        undo()
    assert out.result["correct"] is False, out.checks
