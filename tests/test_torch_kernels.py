"""The port's CUDA kernels against their plain PyTorch versions, on the
card. The kernels have no CPU mode, so every test here is marked
``cuda`` and skips without a card. This file imports neither jax nor the
reference package, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

Tolerance: kernel and plain version form the same products at each tier
and differ only in f32 accumulation order, so distances agree to 1e-5 of
(|x|² + |y|²) and labels agree except at near-ties; counts are exact and
two runs of a kernel are bitwise equal. The selection kernels (top-k
insertion, radix threshold and emission) are exact: their output equals
the plain version's, bit for bit. chip_smoke.py runs the same checks
with ties, NaN rows and padded rows, and at full size.
"""

import pytest
import torch

from raft_tpu_torch import kernels
from raft_tpu_torch.linalg import contractions as tc
from raft_tpu_torch.matrix import radix_select as trs
from raft_tpu_torch.matrix import topk_insert as tti
from raft_tpu_torch.neighbors import fused_topk as tft

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
@pytest.mark.parametrize("name", ["fused_argmin", "fused_lloyd",
                                  "pairwise_tile"])
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


def _counted(name, fn):
    before = kernels.launch_counts()[name]
    out = fn()
    assert kernels.launch_counts()[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "cosine", "inner"])
@pytest.mark.parametrize("tier", TIERS)
def test_fused_topk_matches_plain_on_card(card, tier, metric):
    m, n, kd, k = 300, 1100, 37, 50               # ragged, several splits
    g = torch.Generator(device=card).manual_seed(13)
    x = torch.randn(m, kd, generator=g, device=card)
    y = torch.randn(n, kd, generator=g, device=card)
    y[900] = y[3]                                 # tie: column 3 first
    x[1] = float("nan")                           # no candidate at all
    xs, ys = tc._side(x, tier), tc._side(y, tier)
    got = _counted("fused_topk", lambda: tft._fused_topk(
        tier, metric, xs, ys, m, n, kd, k))
    again = tft._fused_topk(tier, metric, xs, ys, m, n, kd, k)
    want = tft._fused_topk_plain(tier, metric, xs, ys, m, n, kd, k)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert got[1][1].tolist() == [0] * k
    same = got[1] == want[1]
    assert float(same.float().mean()) >= 0.99
    scale = float(((x[~x.isnan().any(1)] ** 2).sum(1).max()
                   + (y * y).sum(1).max()))
    fin = torch.isfinite(want[0])
    assert float((got[0] - want[0]).abs()[fin].max()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_topk_insert_matches_plain_on_card(card, dtype, select_min):
    g = torch.Generator(device=card).manual_seed(14)
    v = torch.randn(77, 5003, generator=g, device=card).to(dtype)
    v[:, 100:200] = v[:, 7:8]                     # ties
    v[3] = float("nan")
    v[4, :-10] = float("inf") if select_min else float("-inf")
    v[5] = torch.sort(v[5].float(), descending=select_min).values.to(dtype)
    for k in (1, 64, 256):
        got = _counted("topk_insert", lambda: tti._topk_insert(
            v, k, select_min))
        want = tti._insert_plain(v, k, select_min)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(3, 300001), (700, 5000)])
def test_radix_kernels_match_plain_on_card(card, rows, cols):
    g = torch.Generator(device=card).manual_seed(15)
    v = torch.randn(rows, cols, generator=g, device=card)
    v[0, 50:5000] = -3.0                          # a long tie run
    v[-1] = 1.0                                   # all equal
    keys = trs._to_key(v, True)
    for k in (1, 77, 4096, cols):
        t, ntie = _counted("radix_threshold",
                           lambda: trs._radix_threshold(keys, k))
        pt, pntie = trs._threshold_plain(keys, k)
        assert torch.equal(t, pt) and torch.equal(ntie, pntie)
        idx = _counted("radix_emit", lambda: trs._radix_emit(keys, t, ntie,
                                                             k))
        assert torch.equal(idx, trs._emit_plain(keys, pt, pntie, k))
