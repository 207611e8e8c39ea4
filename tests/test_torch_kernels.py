"""The port's CUDA kernels against their plain PyTorch versions, on the
card. The kernels have no CPU mode, so every test here is marked
``cuda`` and skips without a card. This file imports neither jax nor the
reference package, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

Tolerance: kernel and plain version form the same products at each tier
and differ only in f32 accumulation order, so distances agree to 1e-5 of
(|x|² + |y|²) and labels agree except at near-ties; counts are exact and
two runs of a kernel are bitwise equal. chip_smoke.py runs the same
checks with ties, NaN rows and padded rows, and at full size.
"""

import pytest
import torch

from raft_tpu_torch import kernels
from raft_tpu_torch.linalg import contractions as tc

TIERS = ("default", "high", "highest")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _run(name, tier, xs, ys, m, n, k):
    if name == "pairwise_tile":
        return (tc._pairwise_tile(tier, "l2", xs, ys, m, n, k),), \
            (tc._pairwise_plain(tier, "l2", xs, ys, m, n, k),)
    if name == "fused_argmin":
        return tc._fused_argmin(tier, "l2", xs, ys, m, n, k), \
            tc._argmin_plain(tier, "l2", xs, ys, m, n, k)
    return tc._fused_lloyd(tier, xs, ys, m, n, k), \
        tc._lloyd_plain(tier, xs, ys, m, n, k)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("name", sorted(kernels.REGISTRY))
def test_kernel_matches_plain_on_card(card, name, tier):
    m, n, k = 333, 177, 50                       # ragged in every dim
    g = torch.Generator(device=card).manual_seed(11)
    x = torch.randn(m, k, generator=g, device=card)
    y = torch.randn(n, k, generator=g, device=card)
    xs, ys = tc._side(x, tier), tc._side(y, tier)
    before = kernels.launch_counts()[name]
    got, want = _run(name, tier, xs, ys, m, n, k)
    again, _ = _run(name, tier, xs, ys, m, n, k)
    assert kernels.launch_counts()[name] == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    scale = float(((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]).max())
    if name == "pairwise_tile":
        assert float((got[0] - want[0]).abs().max()) <= 1e-5 * scale
        return
    val, idx = got[-2:]
    pval, pidx = want[-2:]
    same = idx == pidx
    assert float(same.float().mean()) >= 0.99
    assert float((val - pval).abs()[same].max()) <= 1e-5 * scale
    if name == "fused_lloyd":
        sums, counts = got[:2]
        assert torch.equal(counts, torch.bincount(idx.long(),
                                                  minlength=n).float())
        if bool(same.all()):
            mag = torch.zeros(n, k, device=card).index_add_(0, idx.long(),
                                                            x.abs())
            assert bool(((sums - want[0]).abs() <= 1e-5 * mag + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("tier", TIERS)
def test_lloyd_many_row_tiles_per_block(card, tier):
    """Three persistent blocks over eight row tiles, the last one ragged,
    so each block adds several tiles into its partial sums, as at full
    size. Labels, distances and counts do not depend on the grid; sums
    match the one-tile-a-block grid and the plain version to 1e-5 of the
    cluster's |x| mass (only the f32 summation order differs)."""
    m, n, k = 1000, 37, 24
    g = torch.Generator(device=card).manual_seed(12)
    x = torch.randn(m, k, generator=g, device=card)
    y = torch.randn(n, k, generator=g, device=card)
    xs, ys = tc._side(x, tier), tc._side(y, tier)
    blocks = 3
    assert -(-m // tc.TILE_M) > blocks
    got = tc._fused_lloyd(tier, xs, ys, m, n, k, blocks)
    again = tc._fused_lloyd(tier, xs, ys, m, n, k, blocks)
    one_tile = tc._fused_lloyd(tier, xs, ys, m, n, k)
    want = tc._lloyd_plain(tier, xs, ys, m, n, k)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    for i in (1, 2, 3):                          # counts, distances, labels
        assert torch.equal(got[i], one_tile[i])
    idx = got[3].long()
    mag = torch.zeros(n, k, device=card).index_add_(0, idx, x.abs())
    tol = 1e-5 * mag + 1e-6
    assert bool(((got[0] - one_tile[0]).abs() <= tol).all())
    same = idx == want[3].long()
    assert float(same.float().mean()) >= 0.99
    if bool(same.all()):
        assert torch.equal(got[1], want[1])
        assert bool(((got[0] - want[0]).abs() <= tol).all())
