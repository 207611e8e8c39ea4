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
the plain version's, bit for bit. The CSR kernels (SpMV, SpMM) agree
with their plain versions to 2e-5 of (|A|·|B|)_row + 2e-5 in f32, and
1e-12 of it + 1e-12 in f64 (sums in another order), with NaN in the same places, empty rows exactly 0 and
two runs bitwise equal. chip_smoke.py runs the same checks with ties,
NaN rows and padded rows, and at full size.
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


def _card_csr(card, dtype, n_rows=3000, n_cols=2500, hub=20000, pad=100):
    """A CSR on the card: rows of 0-20 entries (a third empty), one hub row
    of ``hub`` entries, and ``pad`` physical entries past indptr[-1] with
    NaN data, which must never be read."""
    g = torch.Generator(device=card).manual_seed(16)
    lengths = torch.randint(0, 21, (n_rows,), generator=g, device=card)
    lengths[torch.rand(n_rows, generator=g, device=card) < 0.33] = 0
    lengths[7] = hub
    indptr = torch.zeros(n_rows + 1, dtype=torch.int32, device=card)
    indptr[1:] = torch.cumsum(lengths, 0)
    nnz = int(indptr[-1])
    indices = torch.randint(0, n_cols, (nnz + pad,), generator=g,
                            device=card, dtype=torch.int32)
    data = torch.randn(nnz + pad, generator=g, device=card, dtype=dtype)
    data[nnz:] = float("nan")
    return indptr, indices, data, g


def _assert_csr_close(got, want, indptr, indices, data, b):
    """|kernel - plain| <= rel (|A|·|B|) + rel, NaN in the same places:
    rel 2e-5 in f32, 1e-12 in f64, where an f32 sum would miss by ~1e-7."""
    from raft_tpu_torch.sparse import grid_spmv as tg

    rel = 2e-5 if got.dtype == torch.float32 else 1e-12
    n_rows = indptr.shape[0] - 1
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    mass = (tg._spmm_plain(indptr, indices, data.abs(), b.abs().reshape(
        b.shape[0], -1), n_rows)).reshape(got.shape)
    fin = torch.isfinite(want)
    assert bool(((got - want).abs()[fin] <= rel * mass[fin] + rel).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 2, 31, 32, 33, 64])
def test_csr_kernels_match_plain_on_card(card, dtype, k):
    from raft_tpu_torch.sparse import grid_spmv as tg

    indptr, indices, data, g = _card_csr(card, dtype)
    n_rows, n_cols = indptr.shape[0] - 1, 2500
    b = torch.randn(n_cols, k, generator=g, device=card, dtype=dtype)
    b[11, 0] = float("inf")          # rows holding column 11: NaN or inf
    name = "csr_spmv" if k == 1 else "csr_spmm"
    got = _counted(name, lambda: tg._spmm(indptr, indices, data, b, n_rows))
    again = tg._spmm(indptr, indices, data, b, n_rows)
    assert got.dtype == dtype and got.shape == (n_rows, k)
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))
    want = tg._spmm_plain(indptr, indices, data, b, n_rows)
    _assert_csr_close(got, want, indptr, indices, data, b)
    empty = (indptr[1:] == indptr[:-1])
    assert bool((got[empty] == 0).all())


@pytest.mark.cuda
def test_csr_spmv_empty_matrix_and_int64_indptr_on_card(card):
    from raft_tpu_torch.sparse import grid_spmv as tg

    indptr = torch.zeros(65, dtype=torch.int64, device=card)
    indices = torch.zeros(0, dtype=torch.int32, device=card)
    data = torch.zeros(0, device=card)
    y = _counted("csr_spmv", lambda: tg._spmv(indptr, indices, data,
                                             torch.ones(64, device=card), 64))
    assert torch.equal(y, torch.zeros(64, device=card))
    ip, ind, d, g = _card_csr(card, torch.float32, hub=300)
    x = torch.randn(2500, generator=g, device=card)
    got = tg._spmv(ip.long(), ind, d, x, ip.shape[0] - 1)
    assert torch.equal(got, tg._spmv(ip, ind, d, x, ip.shape[0] - 1))


@pytest.mark.cuda
def test_duplicate_sums_on_card_match_the_cpu(card):
    """sparse.op folds runs of equal keys in one fixed order, with no
    atomics: the card gives the CPU's bits, run after run."""
    from raft_tpu_torch.core.sparse_types import COOMatrix
    from raft_tpu_torch.sparse import op

    g = torch.Generator().manual_seed(17)
    rows = torch.randint(0, 50, (20000,), generator=g, dtype=torch.int32)
    cols = torch.randint(0, 50, (20000,), generator=g, dtype=torch.int32)
    data = torch.randn(20000, generator=g)
    want = op.sum_duplicates(COOMatrix(rows, cols, data, (50, 50)))
    on_card = COOMatrix(rows.to(card), cols.to(card), data.to(card), (50, 50))
    for _ in range(2):
        got = op.sum_duplicates(on_card)
        assert torch.equal(got.rows.cpu(), want.rows)
        assert torch.equal(got.cols.cpu(), want.cols)
        assert torch.equal(got.data.cpu(), want.data)
