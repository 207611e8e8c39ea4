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
1e-12 of it + 1e-12 in f64 (sums in another order), with NaN in the
same places, empty rows exactly 0 and two runs bitwise equal (int32 or
int64 indptr alike). The
unexpanded tile sums each output depth by depth in order, as its plain
version does, so the two are bitwise equal but for lp's pow (1e-5 * sqrt(k)
of the value). The MST E-stage is a min under a strict order: exact. The
1-NN probe forms the fused kernels' products: exact on integer data,
indices equal but at near-ties otherwise. chip_smoke.py runs the same
checks with ties, NaN rows and padded rows, and at full size.
"""

import pytest
import torch

from raft_tpu_torch import kernels
from raft_tpu_torch.linalg import contractions as tc
from raft_tpu_torch.matrix import radix_select as trs
from raft_tpu_torch.matrix import topk_insert as tti
from raft_tpu_torch.neighbors import fused_topk as tft
from raft_tpu_torch.sparse.grid_spmv import SPMM_SEG

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
@pytest.mark.parametrize("metric", ["l2", "cosine", "inner"])
@pytest.mark.parametrize("tier", TIERS)
def test_pairwise_tile_shapes_on_card(card, tier, metric):
    """The distance tile at ragged shapes around its 64-row warpgroup and
    128 x 128 tile (the wgmma fragment's row and column map shows only
    there), depths that need zero columns on the wgmma route (50) and
    more than one 64-deep stage (128, 200), and x as a strided view
    (ldx > k): each case twice, bitwise equal, and within 1e-5 of
    (|x|² + |y|²) of the plain version."""
    g = torch.Generator(device=card).manual_seed(21)
    sizes = (1, 63, 64, 65, 333)
    for k in (8, 16, 50, 128, 200):
        for m in sizes:
            for n in sizes:
                wide = torch.randn(m, k + 8, generator=g, device=card)
                x = wide[:, :k] if (m + n) % 2 else wide[:, :k].contiguous()
                y = torch.randn(n, k, generator=g, device=card)
                if tier != "high":
                    xs = tc.Side(x, None, tc._sq_norms(x))
                else:
                    xs = tc._side(x.contiguous(), tier)
                ys = tc._side(y, tier)
                got = _counted("pairwise_tile", lambda: tc._pairwise_tile(
                    tier, metric, xs, ys, m, n, k))
                again = tc._pairwise_tile(tier, metric, xs, ys, m, n, k)
                want = tc._pairwise_plain(tier, metric, xs, ys, m, n, k)
                assert torch.equal(got, again), (m, n, k)
                scale = float(((x * x).sum(1)[:, None]
                               + (y * y).sum(1)[None, :]).max())
                if metric == "cosine":
                    scale = 1.0
                err = float((got - want).abs().max())
                assert err <= 1e-5 * scale, (m, n, k, err)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", TIERS)
def test_pairwise_tile_many_tiles_a_block_on_card(card, tier):
    """More output tiles than multiprocessors, so that each persistent
    block of the wgmma route walks several tiles, with one 64-deep stage
    a tile (k = 24) and with four (k = 200, more stages than the ring
    holds): as the sweep above, bitwise repeatable and within 1e-5."""
    g = torch.Generator(device=card).manual_seed(22)
    for m, n, k in ((3000, 2000, 24), (4000, 1100, 200)):
        x = torch.randn(m, k, generator=g, device=card)
        y = torch.randn(n, k, generator=g, device=card)
        xs, ys = tc._side(x, tier), tc._side(y, tier)
        got = _counted("pairwise_tile", lambda: tc._pairwise_tile(
            tier, "l2", xs, ys, m, n, k))
        assert torch.equal(got, tc._pairwise_tile(tier, "l2", xs, ys, m, n,
                                                   k))
        want = tc._pairwise_plain(tier, "l2", xs, ys, m, n, k)
        scale = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
        assert bool(((got - want).abs() <= 1e-5 * scale).all()), (m, n, k)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", TIERS)
def test_lloyd_many_row_tiles_per_block(card, tier):
    """Three persistent blocks over eight row tiles, the last one ragged,
    so each block of the argmin walks several row tiles, as at full size.
    Labels, distances, counts and sums do not depend on the grid (the
    sums are taken from the labels alone, in row order); sums match the
    plain version to 1e-5 of the cluster's |x| mass (only the f32
    summation order differs)."""
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
    for a, b in zip(got, one_tile):      # sums, counts, distances, labels
        assert torch.equal(a, b)
    idx = got[3].long()
    mag = torch.zeros(n, k, device=card).index_add_(0, idx, x.abs())
    tol = 1e-5 * mag + 1e-6
    same = idx == want[3].long()
    assert float(same.float().mean()) >= 0.99
    if bool(same.all()):
        assert torch.equal(got[1], want[1])
        assert bool(((got[0] - want[0]).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("m,n,k", [(20000, 8192, 128), (3001, 129, 50),
                                   (129, 1, 8), (1, 300, 45)])
def test_lloyd_shapes_on_card(card, tier, m, n, k):
    """8,192 clusters at depth 128 (past the old per-block scratch cap),
    and ragged m, n and k around the 128-row tile and the 8-column depth
    step of the wgmma route: labels equal but at near-ties, distances
    and sums within 1e-5 of the plain version's scale, counts exact, and
    two grids bitwise equal in all four outputs."""
    g = torch.Generator(device=card).manual_seed(31)
    x = torch.randn(m, k, generator=g, device=card)
    y = torch.randn(n, k, generator=g, device=card)
    xs, ys = tc._side(x, tier), tc._side(y, tier)
    got = _counted("fused_lloyd", lambda: tc._fused_lloyd(
        tier, xs, ys, m, n, k))
    for a, b in zip(got, tc._fused_lloyd(tier, xs, ys, m, n, k, 2)):
        assert torch.equal(a, b)
    sums, counts, val, idx = got
    want = tc._lloyd_plain(tier, xs, ys, m, n, k)
    assert torch.equal(counts, torch.bincount(idx.long(),
                                              minlength=n).float())
    scale = (x * x).sum(1) + float((y * y).sum(1).max())
    same = idx == want[3]
    assert float(same.float().mean()) >= 0.99
    d = tc._pairwise_plain(tier, "l2", xs, ys, m, n, k)
    rows = torch.arange(m, device=card)
    gap = (d[rows, idx.long()] - d[rows, want[3].long()]).abs()
    assert bool((gap[~same] <= 1e-5 * scale[~same]).all())
    assert bool(((val - want[2]).abs()[same] <= 1e-5 * scale[same]).all())
    if tier == "high":                 # the summed rows: hi and lo halves
        parts = [xs.v0.float(), xs.v1.float()]
    elif tier == "default":            # the bf16-rounded rows
        parts = [x.to(torch.bfloat16).float()]
    else:
        parts = [x]
    own = torch.zeros(n, k, device=card)
    mag = torch.zeros(n, k, device=card)
    for p in parts:
        own.index_add_(0, idx.long(), p)
        mag.index_add_(0, idx.long(), p.abs())
    assert bool(((sums - own).abs() <= 1e-5 * mag + 1e-6).all())


def _counted(name, fn):
    before = kernels.launch_counts()[name]
    out = fn()
    assert kernels.launch_counts()[name] == before + 1
    return out


def _tied_data(g, card, m, n, kd, edge):
    """Normal rows with ties across the split edge at column ``edge``
    (query 0 nearest to columns 3 and edge, query 2 to edge - 1 and
    edge + 1: the smaller column first), a NaN query (row 1) and a NaN
    column (40)."""
    x = torch.randn(m, kd, generator=g, device=card)
    y = torch.randn(n, kd, generator=g, device=card)
    y[edge] = y[3]
    if edge + 1 < n:
        y[edge + 1] = y[edge - 1]
    x[0] = y[3] + 1e-3
    x[2] = y[edge - 1]
    x[1] = float("nan")
    y[40] = float("nan")
    return x, y


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "cosine", "inner"])
@pytest.mark.parametrize("tier", TIERS)
def test_fused_topk_matches_plain_on_card(card, tier, metric):
    """Ragged m, n and depth (not multiples of 128 or 8), k in {1, 50,
    64, 255, 256} and n < k, ties across a split edge, a NaN row and a
    NaN column: indices equal to the plain version's but at near-ties,
    values within 1e-5 of the scale, empty slots (+inf, 0); two runs and
    two explicit split counts bitwise equal to the planned call."""
    g = torch.Generator(device=card).manual_seed(13)
    for m, n, kd, edge in ((300, 1100, 37, 640), (129, 200, 45, 128)):
        x, y = _tied_data(g, card, m, n, kd, edge)
        xs, ys = tc._side(x, tier), tc._side(y, tier)
        n_tiles = -(-n // tc.TILE_N)
        for k in (1, 50, 64, 255, 256):
            got = _counted("fused_topk", lambda: tft._fused_topk(
                tier, metric, xs, ys, m, n, kd, k))
            for splits in (None, 2, n_tiles):
                again = tft._fused_topk(tier, metric, xs, ys, m, n, kd, k,
                                        splits)
                assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                    (m, k, splits)
            want = tft._fused_topk_plain(tier, metric, xs, ys, m, n, kd, k)
            assert got[1][1].tolist() == [0] * k
            fin = torch.isfinite(want[0])
            assert torch.equal(fin, torch.isfinite(got[0]))
            assert not bool(got[1][~fin].any())
            same = got[1] == want[1]
            assert float(same.float().mean()) >= 0.99, (m, k)
            scale = float(((x[~x.isnan().any(1)] ** 2).sum(1).max()
                           + (y[~y.isnan().any(1)] ** 2).sum(1).max()))
            if metric == "cosine":
                scale = 1.0
            err = (got[0] - want[0]).abs()[fin]
            assert float(err.max()) <= 1e-5 * scale, (m, k)
            if metric == "l2" and k > 1:
                assert got[1][0, :2].tolist() == [3, edge]
                if edge + 1 < n:
                    assert got[1][2, :2].tolist() == [edge - 1, edge + 1]


def _argmin_data(g, card, m, n, kd, edge, dup, nan_col):
    """Normal rows with ties the smaller column must win: row 0 a copy of
    column 3, which column ``edge`` (a split edge) duplicates; row 2 a
    copy of column edge - 1, duplicated at edge + 1; row 4 a copy of
    column 7, duplicated at ``dup`` (past a tile edge where n spans
    several). Row 1 is NaN; column ``nan_col``, when given, is NaN and
    must win every other row."""
    x = torch.randn(m, kd, generator=g, device=card)
    y = torch.randn(n, kd, generator=g, device=card)
    y[edge], y[edge + 1], y[dup] = y[3], y[edge - 1], y[7]
    x[0], x[2], x[4] = y[3], y[edge - 1], y[7]
    x[1] = float("nan")
    if nan_col is not None:
        y[nan_col] = float("nan")
    return x, y


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "cosine", "inner"])
@pytest.mark.parametrize("tier", ["default", "high"])
def test_fused_argmin_wgmma_walks_on_card(card, tier, metric):
    """The wgmma route against its plain version: ragged m, n and depth
    (n past a tile and a split edge, depth not a multiple of 8), ties
    across a tile edge and a split edge (the smaller column wins), a NaN
    row ((NaN, 0)) and a NaN column in the last split (it wins every
    other row); outputs bitwise equal on the row-owning walk and the
    split walk, on several grids and split counts; both fold forms (the
    branching one at n < 128, one cut tile)."""
    g = torch.Generator(device=card).manual_seed(21)
    folds = set()
    for m, n, kd, edge, dup in ((300, 1100, 37, 640, 130),
                                (129, 300, 45, 256, 130),
                                (300, 100, 37, 40, 60)):
        n_tiles = -(-n // tc.TILE_N)
        folds.add(tc._argmin_plan(m, n).fold)
        for nan_col in (None, n - 5):
            x, y = _argmin_data(g, card, m, n, kd, edge, dup, nan_col)
            xs, ys = tc._side(x, tier), tc._side(y, tier)
            got = _counted("fused_argmin", lambda: tc._fused_argmin(
                tier, metric, xs, ys, m, n, kd))
            walks = set()
            for blocks, splits in ((None, 1), (2, 1), (None, 2), (3, 2),
                                   (None, n_tiles), (1, n_tiles)):
                walks.add(tc._argmin_plan(m, n, splits=splits).walk)
                again = tc._fused_argmin(tier, metric, xs, ys, m, n, kd,
                                         blocks=blocks, splits=splits)
                assert torch.equal(got[1], again[1]), (m, blocks, splits)
                assert torch.equal(got[0].view(torch.int32),
                                   again[0].view(torch.int32))
            assert walks == ({"row", "split"} if n_tiles > 1 else {"row"})
            want = tc._argmin_plain(tier, metric, xs, ys, m, n, kd)
            assert int(got[1][1]) == 0 and bool(torch.isnan(got[0][1]))
            if nan_col is not None:
                assert bool((got[1][2:] == nan_col).all()) and int(
                    got[1][0]) == nan_col
                assert bool(torch.isnan(got[0]).all())
                assert torch.equal(got[1], want[1])
                continue
            if metric != "inner":
                assert got[1][[0, 2, 4]].tolist() == [3, edge - 1, 7]
            live = torch.ones(m, dtype=torch.bool, device=card)
            live[1] = False
            same = (got[1] == want[1]) & live
            assert float(same.float().sum()) >= 0.99 * (m - 1)
            scale = float((x[live] ** 2).sum(1).max()
                          + (y ** 2).sum(1).max())
            if metric == "cosine":
                scale = 1.0
            err = (got[0] - want[0]).abs()[same]
            assert float(err.max()) <= 1e-5 * scale
    assert folds == {"flat", "branching"}


@pytest.mark.cuda
@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_topk_insert_row_orders_on_card(card, dtype, select_min):
    """Exactly the plain version on rows in every order the seeded,
    shared bound meets: random, sorted for and against the selection,
    constant, with NaN and +-inf runs, short rows (no seed: fewer than k
    sampled keys) and rows of fewer than k insertable keys; k from 1 to
    256."""
    g = torch.Generator(device=card).manual_seed(22)
    bad = float("inf") if select_min else float("-inf")
    for cols in (31, 300, 5003, 65536):
        v = torch.randn(12, cols, generator=g, device=card)
        v[1] = torch.sort(v[1]).values
        v[2] = torch.sort(v[2], descending=True).values
        v[3] = 0.5
        v[4, ::3] = float("nan")
        v[5, ::2] = float("inf")
        v[6, ::2] = float("-inf")
        v[7, : cols // 2] = bad                  # half the row never enters
        v[8] = bad
        v[8, cols // 3] = 1.0                    # one candidate
        desc = torch.sort(v[9], descending=True).values
        v[9] = torch.cat([desc[0::2], desc[1::2]])   # two descending runs
        v[10] = torch.round(v[10])               # many ties
        v[11, cols // 2:] = -v[11, : cols - cols // 2].abs() - 10
        v = v.to(dtype)
        for k in (1, 2, 31, 64, 65, 255, 256):
            if k > cols:
                continue
            got = _counted("topk_insert", lambda: tti._topk_insert(
                v, k, select_min))
            want = tti._insert_plain(v, k, select_min)
            assert torch.equal(got[1], want[1]), (cols, k)
            assert torch.equal(got[0].view(torch.int32),
                               want[0].view(torch.int32)), (cols, k)


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


def _threshold_case(g, card, case):
    """(keys, k values, wanted plan form) of one radix_threshold case:
    int32 sortable keys, some rows as views with ld > len."""
    limit = trs._row_keys_max(trs._smem_optin(card))
    if case in ("row_limit", "stream_limit"):
        n = limit if case == "row_limit" else limit + 1
        v = torch.randn(5, n, generator=g, device=card)
        v[1, 100:9000] = 0.25                      # a long tie run
        keys = trs._to_key(v, True)
        return keys, (1, 64, 1024, n), "row" if case == "row_limit" \
            else "stream"
    if case in ("ld_row", "ld_stream"):
        n = 5003 if case == "ld_row" else 70001
        wide = torch.randint(-2 ** 31, 2 ** 31 - 1, (7, n + 13),
                             generator=g, device=card, dtype=torch.int32)
        keys = wide[:, 5:5 + n]                    # ld > len, misaligned
        return keys, (1, 333, n), "row" if n <= limit else "stream"
    if case in ("low_digits_row", "low_digits_stream"):
        # equal in the top 22 bits (two 11-bit digits), apart in the last
        n = 30000 if case == "low_digits_row" else 200000
        low = torch.randint(0, 1024, (4, n), generator=g, device=card,
                            dtype=torch.int32)
        keys = (low + 0x1234C00).to(torch.int32)
        keys[2] = low[2] - 0x7654C00               # negative keys too
        return keys, (1, 500, n), "row" if n <= limit else "stream"
    if case in ("extremes_row", "extremes_stream"):
        n = 4099 if case == "extremes_row" else 100003
        v = torch.randn(6, n, generator=g, device=card)
        v[0, ::3] = float("nan")
        v[1, ::2] = -float("nan")
        v[2, 1::5] = float("inf")
        v[2, ::7] = -float("inf")
        keys = trs._to_key(v, True)
        keys[3, ::4] = -2 ** 31                    # INT32_MIN
        keys[4, 1::3] = 2 ** 31 - 1                # INT32_MAX
        keys[5, ::2] = -2 ** 31
        keys[5, 1::2] = 2 ** 31 - 1
        return keys, (1, 17, n // 2, n), "row" if n <= limit else "stream"
    if case == "tiny":
        # rows of 3 keys, a view from column 1: the scalar head and tail
        # alone, no 16-byte group
        wide = torch.randint(-5, 5, (6, 4), generator=g, device=card,
                             dtype=torch.int32)
        wide[0] = 7
        return wide[:, 1:], (1, 2, 3), "row"
    # survivors past the candidate buffer: all-equal rows and a tie run
    # longer than the buffer in the first pass's bin
    n = 300000
    v = torch.randn(4, n, generator=g, device=card)
    v[0] = 1.5
    v[1, 1000:150000] = -0.5
    v[2, :] = torch.round(v[2] * 2) / 2            # nine values, long runs
    keys = trs._to_key(v, True)
    return keys, (1, 4096, 120000, n), "stream"


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["row_limit", "stream_limit", "ld_row",
                                  "ld_stream", "low_digits_row",
                                  "low_digits_stream", "extremes_row",
                                  "extremes_stream", "overflow", "tiny"])
def test_radix_threshold_forms_on_card(card, case):
    """Both forms of radix_threshold (row-resident and streaming, as the
    plan picks them) exactly against the plain version: rows on both
    sides of the row-resident limit, ld > len at a misaligned start, keys
    apart only in the last digit, INT32_MIN / INT32_MAX and NaN's keys,
    survivors that overflow the candidate buffer, rows of three keys, k = 1
    and k = len; two runs equal, and the emission exact on the result."""
    g = torch.Generator(device=card).manual_seed(21)
    keys, ks, form = _threshold_case(g, card, case)
    rows, n = keys.shape
    plan = trs._threshold_plan(rows, n, trs._smem_optin(keys.device))
    assert plan.form == form
    for k in ks:
        t, ntie = _counted("radix_threshold",
                           lambda: trs._radix_threshold(keys, k))
        again = trs._radix_threshold(keys, k)
        pt, pntie = trs._threshold_plain(keys, k)
        assert torch.equal(t, pt) and torch.equal(ntie, pntie), (case, k)
        assert torch.equal(t, again[0]) and torch.equal(ntie, again[1])
        if case == "overflow" and k == 120000:
            # row 1's threshold is its tie run: more keys than the buffer
            assert int((keys[1] == t[1]).sum()) > plan.cand_cap
        idx = trs._radix_emit(keys, t, ntie, k)
        assert torch.equal(idx, trs._emit_plain(keys, pt, pntie, k))


def _card_csr(card, dtype, n_rows=3000, n_cols=2500, hub=20000, pad=100):
    """A CSR on the card: rows of 0-20 entries (a third empty), one hub row
    of ``hub`` entries, and ``pad`` physical entries past indptr[-1] with
    NaN data, which must never be read."""
    g = torch.Generator(device=card).manual_seed(16)
    lengths = torch.randint(0, 21, (n_rows,), generator=g, device=card)
    lengths[torch.rand(n_rows, generator=g, device=card) < 0.33] = 0
    lengths[7] = hub
    lengths[9] = 2 * SPMM_SEG          # exactly two warps' shares
    lengths[10] = SPMM_SEG             # exactly one row warp's share
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
@pytest.mark.parametrize("k", [1, 2, 4, 16, 31, 32, 33, 64, 200])
def test_csr_kernels_match_plain_on_card(card, dtype, k):
    """A hub row over many SpMM segments, rows ending exactly on a segment
    boundary, a third of the rows empty, NaN pads: within the band of the
    plain version, bitwise equal run to run and with int64 indptr."""
    from raft_tpu_torch.sparse import grid_spmv as tg

    indptr, indices, data, g = _card_csr(card, dtype)
    n_rows, n_cols = indptr.shape[0] - 1, 2500
    b = torch.randn(n_cols, k, generator=g, device=card, dtype=dtype)
    b[11, 0] = float("inf")          # rows holding column 11: NaN or inf
    name = "csr_spmv" if k == 1 else "csr_spmm"
    got = _counted(name, lambda: tg._spmm(indptr, indices, data, b, n_rows))
    again = tg._spmm(indptr, indices, data, b, n_rows)
    wide = tg._spmm(indptr.long(), indices, data, b, n_rows)
    assert got.dtype == dtype and got.shape == (n_rows, k)
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))
    assert torch.equal(got.view(torch.uint8), wide.view(torch.uint8))
    want = tg._spmm_plain(indptr, indices, data, b, n_rows)
    _assert_csr_close(got, want, indptr, indices, data, b)
    empty = (indptr[1:] == indptr[:-1])
    assert bool((got[empty] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_csr_spmm_all_rows_empty_on_card(card, dtype):
    from raft_tpu_torch.sparse import grid_spmv as tg

    for idx in (torch.int32, torch.int64):
        indptr = torch.zeros(3001, dtype=idx, device=card)
        none = torch.zeros(0, dtype=torch.int32, device=card)
        b = torch.randn(50, 16, device=card, dtype=dtype)
        got = _counted("csr_spmm", lambda: tg._spmm(
            indptr, none, torch.zeros(0, device=card, dtype=dtype), b,
            3000))
        assert torch.equal(got, torch.zeros(3000, 16, device=card,
                                             dtype=dtype))


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_csr_spmv_hub_and_ragged_rows_on_card(card, dtype):
    """csr_spmv's row groups and chunk warps: a hub row of 50,000 entries
    (about 195 chunks), rows of 0 to 300 entries (some past one
    row group's share), NaN pads past indptr[-1]: within the band of the
    plain version, bitwise equal run to run and with int64 indptr."""
    from raft_tpu_torch.sparse import grid_spmv as tg

    g = torch.Generator(device=card).manual_seed(33)
    n_rows, n_cols = 5000, 7000
    lengths = torch.randint(0, 301, (n_rows,), generator=g, device=card)
    lengths[torch.rand(n_rows, generator=g, device=card) < 0.4] = 0
    lengths[17] = 50000
    indptr = torch.zeros(n_rows + 1, dtype=torch.int32, device=card)
    indptr[1:] = torch.cumsum(lengths, 0)
    nnz = int(indptr[-1])
    indices = torch.randint(0, n_cols, (nnz + 77,), generator=g,
                            device=card, dtype=torch.int32)
    data = torch.randn(nnz + 77, generator=g, device=card, dtype=dtype)
    data[nnz:] = float("nan")
    x = torch.randn(n_cols, generator=g, device=card, dtype=dtype)
    got = _counted("csr_spmv", lambda: tg._spmv(indptr, indices, data, x,
                                               n_rows))
    again = tg._spmv(indptr, indices, data, x, n_rows)
    wide = tg._spmv(indptr.long(), indices, data, x, n_rows)
    assert got.dtype == dtype and got.shape == (n_rows,)
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))
    assert torch.equal(got.view(torch.uint8), wide.view(torch.uint8))
    want = tg._spmv_plain(indptr, indices, data, x, n_rows)
    _assert_csr_close(got[:, None], want[:, None], indptr, indices, data, x)
    assert bool((got[lengths == 0] == 0).all())


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("metric", ["l1", "linf", "canberra", "lp",
                                    "hamming", "l2un"])
def test_unexpanded_tile_matches_plain_on_card(card, metric, dtype):
    g = torch.Generator(device=card).manual_seed(18)
    for m, n, k in ((70, 129, 300), (1, 5, 1), (130, 1, 33)):
        x = torch.randn(m, k, generator=g, device=card, dtype=dtype)
        y = torch.randn(n, k, generator=g, device=card, dtype=dtype)
        y[: n // 2, : k // 2] = x[0, : k // 2]    # exact matches, 0/0
        x[-1, 0] = float("nan")
        got = _counted("unexpanded_tile", lambda: tc._unexpanded_tile(
            metric, 3.0, x, y))
        again = tc._unexpanded_tile(metric, 3.0, x, y)
        want = tc.unexpanded_ref(x, y, metric, 3.0)
        assert got.dtype == dtype and torch.equal(
            got.view(torch.uint8), again.view(torch.uint8))
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        if metric == "lp":
            fin = torch.isfinite(want)
            assert bool(((got - want).abs()[fin]
                         <= 1e-5 * k ** 0.5 * want.abs()[fin]).all())
        else:
            assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


def _unexpanded_operands(g, card, dtype, m, n, k, layout):
    """x [m, k] and y [n, k] on the card: contiguous; rows from an odd
    row of a contiguous buffer (16-byte aligned where k's row is); or
    views whose staging must go element by element (x in a wider buffer
    with a row stride of k + 1, y a slice from an odd row and column 1)."""
    if layout == "contiguous":
        x = torch.randn(m, k, generator=g, device=card, dtype=dtype)
        y = torch.randn(n, k, generator=g, device=card, dtype=dtype)
    elif layout == "row_slice":
        x = torch.randn(m + 1, k, generator=g, device=card, dtype=dtype)[1:]
        y = torch.randn(n + 3, k, generator=g, device=card, dtype=dtype)[3:]
    else:
        x = torch.randn(m, k + 1, generator=g, device=card,
                        dtype=dtype)[:, :k]
        y = torch.randn(n + 3, k + 2, generator=g, device=card,
                        dtype=dtype)[3:, 1:k + 1]
    y[: n // 2, : k // 2] = x[0, : k // 2]        # exact matches, 0/0
    if n > 2:
        y[-1, k // 3] = float("inf")
    x[-1, -1] = float("nan")                      # NaN in the last depth
    return x, y


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("metric", ["l1", "linf", "canberra", "lp",
                                    "hamming", "l2un"])
def test_unexpanded_tile_edges_on_card(card, metric, dtype):
    """The register-blocked tile at m and n off its block tile (64 x 128
    in f32, 64 x 64 in f64), depths 1, 3, 50 and 129 (a partial last
    chunk and a partial last 16-byte group), both stagings, which the
    kernel picks from the operands' alignment (16-byte copies where both
    start on a 16-byte boundary with row strides of 16-byte multiples, as
    contiguous rows of k = 32 or 128 f32 do from any row; element by
    element for k = 50 f32, a row stride of k + 1 and a slice from an odd
    row and column), NaN in linf's last depth: bitwise equal to the plain
    version (lp within 1e-5 sqrt(k) of the value) and two runs bitwise
    equal."""
    g = torch.Generator(device=card).manual_seed(22)
    for m, n, k in ((130, 257, 129), (1, 5, 1), (129, 1, 3), (300, 70, 50),
                    (64, 128, 32), (257, 131, 128)):
        for layout in ("contiguous", "row_slice", "strided"):
            x, y = _unexpanded_operands(g, card, dtype, m, n, k, layout)
            got = _counted("unexpanded_tile", lambda: tc._unexpanded_tile(
                metric, 3.0, x, y))
            again = tc._unexpanded_tile(metric, 3.0, x, y)
            want = tc.unexpanded_ref(x, y, metric, 3.0)
            what = (metric, dtype, m, n, k, layout)
            assert got.dtype == dtype and torch.equal(
                got.view(torch.uint8), again.view(torch.uint8)), what
            assert torch.equal(torch.isnan(got), torch.isnan(want)), what
            if metric == "linf":
                assert bool(torch.isnan(got[-1]).all()), what
            if metric == "lp":
                fin = torch.isfinite(want)
                assert bool(((got - want).abs()[fin]
                             <= 1e-5 * k ** 0.5 * want.abs()[fin]).all()), \
                    what
            else:
                assert torch.equal(torch.nan_to_num(got),
                                   torch.nan_to_num(want)), what


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mst_min_edge_matches_plain_on_card(card, dtype):
    """A hub row, empty rows, NaN pads past indptr[-1] (never read), all-
    equal weights and several colorings: exactly the plain version."""
    from raft_tpu_torch.sparse.solver import mst_grid as tmg

    indptr, indices, data, g = _card_csr(card, dtype, n_rows=3000,
                                         n_cols=3000)
    for weights in (data, torch.where(torch.isnan(data), data, 1.0)):
        plan = tmg.MSTPlan(indptr=indptr, indices=indices, data=weights,
                           n=3000, n_cols=3000, n_edges=int(indptr[-1]))
        for colors in (torch.arange(3000, device=card),
                       torch.randint(0, 40, (3000,), generator=g,
                                     device=card),
                       torch.zeros(3000, device=card)):
            colors = colors.to(torch.int32)
            got = _counted("mst_min_edge",
                           lambda: tmg._min_edge(plan, colors))
            want = tmg._min_edge_plain(indptr, indices, weights, colors,
                                       3000, 3000)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_mst_on_card_equals_mst_on_the_cpu(card):
    import numpy as np
    import scipy.sparse as sp

    from raft_tpu_torch.core.sparse_types import CSRMatrix
    from raft_tpu_torch.sparse.solver import mst

    rng = np.random.default_rng(19)
    d = np.round(rng.random((400, 400)), 1).astype(np.float32)
    d[rng.random((400, 400)) > 0.02] = 0
    a = sp.csr_matrix(np.maximum(d, d.T))
    for pad in (True, False):
        on_card = CSRMatrix.from_scipy(a, pad=pad).to_device()
        cpu = on_card.to_host()
        c1 = np.arange(400, dtype=np.int32)
        c2 = c1.copy()
        f1 = mst(None, on_card, color=c1)
        f2 = mst(None, cpu, color=c2)
        assert np.array_equal(c1, c2)
        for field in ("src", "dst", "weights"):
            assert torch.equal(getattr(f1, field).cpu(), getattr(f2, field))


@pytest.mark.cuda
@pytest.mark.parametrize("tier", TIERS)
def test_minonly_matches_plain_on_card(card, tier):
    """Bitwise equal to the plain version on integer data (every sum
    exact), indices equal but at near-ties otherwise; ragged m, n and
    depth, a tie across a split edge (the smaller column wins), a NaN
    row ((+inf, 0)) and a NaN column; two runs and two explicit split
    counts bitwise equal to the planned call."""
    g = torch.Generator(device=card).manual_seed(20)
    for m, n, kd, edge in ((300, 5000, 37, 2560), (129, 200, 45, 128)):
        n_tiles = -(-n // tc.TILE_N)
        for integer in (True, False):
            x, y = _tied_data(g, card, m, n, kd, edge)
            if integer:
                x, y = torch.round(2 * x), torch.round(2 * y)
            x[0] = y[3]
            xs, ys = tc._side(x, tier), tc._side(y, tier)
            got = _counted("minonly", lambda: tft._minonly(tier, xs, ys, m,
                                                           n, kd))
            for splits in (None, 2, n_tiles):
                again = tft._minonly(tier, xs, ys, m, n, kd, splits=splits)
                assert all(torch.equal(a, b) for a, b in zip(got, again))
            want = tft._minonly_plain(tier, xs, ys, m, n, kd)
            assert int(got[1][0]) == 3
            assert int(got[1][2]) == edge - 1
            assert float(got[0][1]) == float("inf") and int(got[1][1]) == 0
            if integer:                            # every sum exact
                assert torch.equal(got[0], want[0]) and torch.equal(
                    got[1], want[1])
                continue
            live = ~x.isnan().any(1)
            scale = float(((x[live] ** 2).sum(1).max()
                           + (y[~y.isnan().any(1)] ** 2).sum(1).max()))
            same = got[1] == want[1]
            assert float(same.float().mean()) >= 0.99
            assert float((got[0] - want[0]).abs()[live].max()) <= \
                1e-5 * scale
