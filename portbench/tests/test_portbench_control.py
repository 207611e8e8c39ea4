"""The control: the program's own lower tier ('default', one bf16 pass,
below the cells' 'high') must come out not correct in every cell, here
at a tiny size on the CPU (the kernels' plain versions keep each tier's
rounding) and, on a card, at the cells' own sizes."""

import time

import pytest

from portbench import harness
from portbench.tests.conftest import BENCH, TINY, run_tiny


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_control_fails_at_a_tiny_size(cell):
    out = run_tiny(cell, tier="default")
    assert out.result["correct"] is False, out.checks


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_sound_tier_passes_at_a_tiny_size(cell):
    out = run_tiny(cell, seed=5)
    assert out.result["correct"] is True, out.checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_control_fails_at_the_cells_size_on_the_card(card, cell):
    for seed in (101, 2**31 + 3, 987654321):
        out = harness.run(cell, seed, 2.0, False, t_start=time.monotonic(),
                          tier="default", bench=BENCH)
        assert out.result["correct"] is False, out.checks
