"""The port's contraction engine (raft_tpu_torch/linalg/contractions.py)
against the reference package's Pallas kernels (interpret mode on the
CPU), for each of the three kernels' functions at all three tiers.

Tolerances, and why:

- 'high' (bf16x3) and 'highest' (f32): both packages form the same
  products; only the f32 accumulation order differs. Distances agree to
  1e-5 of (|x|² + |y|²); labels agree except at near-ties (two columns
  within that band in exact arithmetic); counts are exact when the
  labels agree; sums agree to 1e-5 of the summed magnitudes.
- 'default': the port's tier is one bf16 pass, as on the TPU, but the
  reference on the CPU computes full f32 at this tier. So the port is
  held tightly (1e-5 of the magnitudes) to a numpy emulation of one bf16
  pass, and only loosely (1e-2) to the reference.

The kernels themselves run only on the card: tests/test_torch_kernels.py
holds each one against its plain version there and skips here.
"""

import numpy as np
import pytest
import torch

from _torch_util import (TIERS, assert_labels_agree, bf16_round, both_tiers,
                         exact_l2, n, one_pass_cross, sq_norms, t)
from raft_tpu.linalg import contractions as jc
from raft_tpu_torch import interop
from raft_tpu_torch.linalg import contractions as tc
from raft_tpu_torch.matrix.epilogue import iota_argmin
from raft_tpu_torch.neighbors import fused_topk as tft
from raft_tpu_torch.util import precision as tprec

REL = 1e-5
METRICS = ("l2", "cosine", "inner")


def _data(seed, m=211, nn=37, k=24):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    y = rng.standard_normal((nn, k)).astype(np.float32)
    return x, y


def _one_pass_metric(metric, x, y, cross=None):
    if cross is None:
        cross = one_pass_cross(x, y)
    xn, yn = sq_norms(x), sq_norms(y)
    if metric == "l2":
        return xn[:, None] - 2 * cross + yn[None, :]
    if metric == "cosine":
        return 1 - cross / np.sqrt(np.outer(xn, yn))
    return -cross


def _scale(metric, x, y):
    """Per-element magnitude the tolerance is relative to."""
    xn, yn = sq_norms(x), sq_norms(y)
    if metric == "l2":
        return xn[:, None] + yn[None, :]
    if metric == "cosine":
        return np.ones((x.shape[0], y.shape[0]))
    return np.sqrt(np.outer(xn, yn))


# ---------------------------------------------------------------------------
# operand split
# ---------------------------------------------------------------------------


def test_round_to_bf16_matches_reference_bitwise():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(4096).astype(np.float32) * 1e3
    # exact halfway cases, signed zeros, extremes, inf and NaN payloads
    halfway = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x7F7FFFFF,
                        0x00000001, 0x80000000, 0x7F800000, 0x7FC00000,
                        0x7FFFFFFF], np.uint32).view(np.float32)
    a = np.concatenate([a, halfway])
    want = n(jc._round_to_bf16_f32(a)).view(np.uint32)
    got = n(tc._round_to_bf16_f32(t(a))).view(np.uint32)
    np.testing.assert_array_equal(got, want)
    finite = np.isfinite(a)
    np.testing.assert_array_equal(got[finite],
                                  bf16_round(a[finite]).view(np.uint32))


def test_split_operands_match_reference_bitwise():
    """lloyd_prepare's X operands: the bf16 halves are bit-identical to
    the reference's; the f32 norms agree to rounding."""
    x, _ = _data(1)
    with both_tiers("high"):
        (jh, jl, jn), jmeta = jc.lloyd_prepare(x, 37)
        (th, tl, tn), tmeta = tc.lloyd_prepare(t(x), 37)
    m, k = x.shape
    assert tmeta == {"m": m} and jmeta["m"] == m
    for got, want in ((th, jh), (tl, jl)):
        np.testing.assert_array_equal(
            n(got.view(torch.int16)),
            np.asarray(want)[:m, :k].view(np.int16))
    np.testing.assert_allclose(n(tn)[0], np.asarray(jn)[0, :m], rtol=1e-6)


# ---------------------------------------------------------------------------
# pairwise tile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_matches_reference(tier, metric):
    x, y = _data(2, m=150, nn=45, k=19)
    with both_tiers(tier):
        want = n(jc.pairwise_pallas(x, y, metric))
        got = n(tc.pairwise_pallas(t(x), t(y), metric))
    assert got.shape == (150, 45) and got.dtype == np.float32
    scale = _scale(metric, x, y)
    if tier == "default":
        np.testing.assert_array_less(
            np.abs(got - _one_pass_metric(metric, x, y)), REL * scale + 1e-6)
        np.testing.assert_array_less(np.abs(got - want), 1e-2 * scale)
    else:
        np.testing.assert_array_less(np.abs(got - want), REL * scale + 1e-6)


@pytest.mark.parametrize("tier", ["default", "high"])
@pytest.mark.parametrize("shape", [(63, 65, 50), (1, 333, 19),
                                   (64, 1, 128), (65, 64, 200)])
def test_wgmma_operands_give_the_plain_result(tier, shape):
    """The wgmma route's operands (csrc/pairwise_tile.cu at 'default' and
    'high'): bf16 rows, rounded half to even as the reference rounds,
    zero columns up to a depth of a multiple of 8, 16-byte aligned rows;
    the plain version gives bit for bit the same distances on them as on
    the unpadded operands. x is a strided view (ldx > k)."""
    m, nn, k = shape
    x, y = _data(31, m=m, nn=nn, k=k + 5)
    xt, yt = t(x)[:, :k], t(y)[:, :k].contiguous()
    xs = tc._side(xt if tier == "default" else xt.contiguous(), tier)
    ys = tc._side(yt, tier)
    ws, vs, kp = tc._wgmma_operands(tier, xs, ys, m, nn, k)
    assert kp % tc.WGMMA_DEPTH == 0 and 0 <= kp - k < tc.WGMMA_DEPTH
    for side, w, rows, raw in ((xs, ws, m, xt), (ys, vs, nn, yt)):
        halves = [(w.v0, side.v0)] if tier == "default" else \
            [(w.v0, side.v0), (w.v1, side.v1)]
        for got, src in halves:
            assert got.dtype == torch.bfloat16 and got.shape[1] >= kp
            assert got.stride(0) % 8 == 0 and got.data_ptr() % 16 == 0
            want = (tc._round_to_bf16_f32(raw) if tier == "default"
                    else src[:rows, :k].float())
            assert torch.equal(got[:rows, :k].float(), want)
            assert not bool(got[:rows, k:kp].any())
        assert w.norms is side.norms
    for metric in METRICS:
        assert torch.equal(
            tc._pairwise_plain(tier, metric, ws, vs, m, nn, kp),
            tc._pairwise_plain(tier, metric, xs, ys, m, nn, k))
    if tier == "high" and k % 8 == 0:       # aligned halves: no copy
        assert ws.v0.data_ptr() == xs.v0.data_ptr()


@pytest.mark.parametrize("sqrt", [False, True])
def test_pairwise_l2_clamps_and_roots(sqrt):
    x, y = _data(3, m=60, nn=20, k=9)
    y[:5] = x[:5]                                   # exact self pairs
    with both_tiers("high"):
        want = n(jc.pairwise_l2_pallas(x, y, sqrt=sqrt))
        got = n(tc.pairwise_l2_pallas(t(x), t(y), sqrt=sqrt))
    assert (got >= 0).all()
    scale = _scale("l2", x, y)
    tol = np.sqrt(REL * scale) if sqrt else REL * scale
    np.testing.assert_array_less(np.abs(got - want), tol + 1e-6)


# ---------------------------------------------------------------------------
# fused argmin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("metric", METRICS)
def test_fused_argmin_matches_reference(tier, metric):
    x, y = _data(4)
    with both_tiers(tier):
        jv, ji = jc.fused_argmin_pallas(x, y, metric)
        tv, ti = tc.fused_argmin_pallas(t(x), t(y), metric)
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32
    if tier == "default":
        d = _one_pass_metric(metric, x, y)
    else:   # the metric in f64
        d = _one_pass_metric(metric, x, y, cross=x.astype(np.float64)
                             @ y.astype(np.float64).T)
    scale = _scale(metric, x, y).max(1)
    rel = 1e-2 if tier == "default" else REL   # loose: JAX is f32 there
    assert_labels_agree(n(ti), n(ji), d, scale, rel=rel)
    same = n(ti) == n(ji)
    np.testing.assert_array_less(np.abs(n(tv) - n(jv))[same],
                                 (rel * scale)[same] + 1e-6)
    if tier == "default":        # tight against the one-pass emulation
        np.testing.assert_array_less(
            np.abs(n(tv) - d[np.arange(len(d)), n(ti)]), REL * scale + 1e-6)


@pytest.mark.parametrize("metric", METRICS)
def test_fused_argmin_ties_and_nan_match_reference(metric):
    """A duplicated column is a tie the smaller index wins; a NaN row
    gives a NaN distance at column 0 (NaN is minimal); a NaN column wins
    every row. Under inner, column 5 is made long, so that row 0 (a copy
    of it) is nearest to it there too."""
    x, y = _data(5, m=40, nn=30, k=8)
    if metric == "inner":
        y[5] *= 3
    y[17] = y[5]
    x[0] = y[5]
    x[3] = np.nan
    got = []
    for yy in (y, np.where(np.arange(30)[:, None] == 11, np.nan, y)):
        yy = yy.astype(np.float32)
        with both_tiers("high"):
            jv, ji = jc.fused_argmin_pallas(x, yy, metric)
            tv, ti = tc.fused_argmin_pallas(t(x), t(yy), metric)
        np.testing.assert_array_equal(n(ti), n(ji))
        np.testing.assert_array_equal(np.isnan(n(tv)), np.isnan(n(jv)))
        got.append(n(ti))
        assert n(ti)[3] == 0 and np.isnan(n(tv)[3])
    assert got[0][0] == 5                     # tie: the smaller index
    assert (np.delete(got[1], 3) == 11).all()   # the NaN column is minimal


@pytest.mark.parametrize("m,nn,walk", [
    (1_000_000, 1024, "row"), (1_000_000, 10240, "row"),
    (1 << 20, 4, "row"), (1 << 20, 128, "row"), (4096, 1 << 20, "split"),
    (300, 1100, "split"), (1, 1, "row")])
def test_argmin_plan(m, nn, walk):
    """The fused argmin's wgmma plan: the row-owning walk where X has
    enough row tiles to fill the card (config 3, the k-means|| candidate
    shape, spectral partition's), else the split walk with the fused
    top-k's planning (the kNN shape's 4 splits); splits none empty and
    covering every column tile; the branching fold only where n cuts the
    one tile; scratch only for the split walk's partials, with no term in
    grid x n x k."""
    plan = tc._argmin_plan(m, nn)
    row_tiles, n_tiles = -(-m // tc.TILE_M), -(-nn // tc.TILE_N)
    assert plan.walk == walk and (plan.splits == 1) == (walk == "row")
    assert plan.fold == ("flat" if nn >= tc.TILE_N else "branching")
    assert (plan.splits - 1) * plan.tiles_per_split < n_tiles \
        <= plan.splits * plan.tiles_per_split
    assert plan.units == row_tiles * plan.splits
    assert plan.grid == min(tc.LLOYD_SMS, plan.units)
    assert plan.scratch_bytes == (0 if walk == "row" else 8 * plan.splits * m)
    for other in (tc._argmin_plan(m, nn, blocks=1),
                  tc._argmin_plan(m, nn, sms=plan.grid)):
        assert other.scratch_bytes <= plan.scratch_bytes
    assert tc._argmin_plan(m, nn, blocks=3).grid == min(3, plan.units)
    if 8 * n_tiles <= tft.MERGE_BYTES:       # the top-k's plan at k = 1
        assert plan.splits == tft._split_plan(m, nn, 1, tc.LLOYD_SMS).splits
    for forced in (1, 2, n_tiles, n_tiles + 5):
        fp = tc._argmin_plan(m, nn, splits=forced)
        assert fp.splits == tc._whole_splits(n_tiles, min(forced,
                                                           n_tiles))[0]
        assert fp.walk == ("row" if fp.splits == 1 else "split")
        assert fp.fold == plan.fold
    with pytest.raises(ValueError):
        tc._argmin_plan(m, nn, splits=0)
    if m * nn <= 1 << 20:
        assert tc._argmin_plan(m, nn, splits=n_tiles).splits == n_tiles


@pytest.mark.parametrize("metric", METRICS)
def test_argmin_split_merge_emulated(metric):
    """The split walk in plain torch: each split's (min, first-min
    argmin), folded in split order under the NaN-minimal order (the merge
    kernel's rule), gives the one-call plain version, NaN columns in a
    later split and ties across the split edge included."""
    x, y = _data(7, m=50, nn=700, k=12)
    y[384] = y[3]                    # a tie across the split edge
    x[0] = y[3]
    y[650] = np.nan                  # the last split's NaN column wins
    x[9, 4] = np.nan                 # a NaN row: column 0
    xs, ys = (tc._side(t(a), "high") for a in (x, y))
    want = tc._argmin_plain("high", metric, xs, ys, 50, 700, 12)
    d = tc._pairwise_plain("high", metric, xs, ys, 50, 700, 12)
    plan = tc._argmin_plan(50, 700, splits=2)
    edge = plan.tiles_per_split * tc.TILE_N
    assert plan.splits == 2 and edge == 384
    bv = bi = None
    for c0 in range(0, 700, edge):
        tile = d[:, c0:c0 + edge]
        _, v, i = iota_argmin(tile, tile.shape[1])
        v, i = v[:, 0], i[:, 0] + c0
        if bv is None:
            bv, bi = v, i
            continue
        vn, bn = torch.isnan(v), torch.isnan(bv)
        take = torch.where(vn | bn, vn & ~bn,
                           (v < bv) | ((v == bv) & (i < bi)))
        bv, bi = torch.where(take, v, bv), torch.where(take, i, bi)
    assert torch.equal(bi, want[1])
    assert torch.equal(torch.isnan(bv), torch.isnan(want[0]))
    assert torch.equal(bv.nan_to_num(), want[0].nan_to_num())
    assert int(bi[9]) == 0 and (np.delete(n(bi), 9) == 650).all()


def test_fused_l2_argmin_matches_reference():
    x, y = _data(6, m=300, nn=64, k=32)
    with both_tiers("high"):
        jv, ji = jc.fused_l2_argmin_pallas(x, y)
        tv, ti = tc.fused_l2_argmin_pallas(t(x), t(y))
    d = exact_l2(x, y)
    scale = (sq_norms(x)[:, None] + sq_norms(y)[None, :]).max(1)
    assert_labels_agree(n(ti), n(ji), d, scale)
    assert (n(tv) >= 0).all()
    np.testing.assert_allclose(n(tv), n(jv), atol=REL * scale.max())


# ---------------------------------------------------------------------------
# fused Lloyd pass
# ---------------------------------------------------------------------------


def _check_lloyd(got, want, x, y, tier):
    (ts, tcnt, tv, ti), (js, jcnt, jv, ji) = got, want
    m = x.shape[0]
    assert tuple(ts.shape) == (y.shape[0], x.shape[1])
    scale = (sq_norms(x)[:, None] + sq_norms(y)[None, :]).max(1)
    d = exact_l2(x, y)
    rel = 1e-2 if tier == "default" else REL
    assert_labels_agree(n(ti), n(ji), d, scale, rel=rel)
    np.testing.assert_array_equal(
        n(tcnt), np.bincount(n(ti), minlength=y.shape[0]))
    assert float(tcnt.sum()) == m
    if tier == "default":
        # Σ of the bf16-rounded rows per cluster, in f64
        want_sums = np.zeros(ts.shape)
        np.add.at(want_sums, n(ti), bf16_round(x).astype(np.float64))
        mag = np.zeros(ts.shape)
        np.add.at(mag, n(ti), np.abs(x).astype(np.float64))
        np.testing.assert_array_less(np.abs(n(ts) - want_sums),
                                     REL * mag + 1e-6)
        return
    if (n(ti) == n(ji)).all():
        np.testing.assert_array_equal(n(tcnt), n(jcnt))
        mag = np.zeros(ts.shape)
        np.add.at(mag, n(ti), np.abs(x).astype(np.float64))
        np.testing.assert_array_less(np.abs(n(ts) - n(js)), REL * mag + 1e-6)
    np.testing.assert_allclose(n(tv), n(jv), atol=REL * scale.max())


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("shape", [(211, 37, 24), (64, 5, 3)])
def test_fused_lloyd_matches_reference(tier, shape):
    m, nn, k = shape
    x, y = _data(7, m=m, nn=nn, k=k)
    with both_tiers(tier):
        want = jc.fused_lloyd_pallas(x, y)
        got = tc.fused_lloyd_pallas(t(x), t(y))
    _check_lloyd(got, want, x, y, tier)


def test_lloyd_prepared_takes_reference_operands():
    """The reference's prepared operands (padded to its tile grid) carried
    over bit for bit give the port's prepared pass; the port's own
    prepared pass is bitwise its unprepared one."""
    x, y = _data(8, m=203, nn=29, k=20)
    with both_tiers("high"):
        jops, jmeta = jc.lloyd_prepare(x, 29)
        want = jc.fused_lloyd_prepared(jops, y, **jmeta)
        ops = interop.from_numpy(tuple(np.asarray(o) for o in jops),
                                 device="cpu")
        got = tc.fused_lloyd_prepared(ops, t(y), m=jmeta["m"])
        _check_lloyd(got, want, x, y, "high")
        tops, tmeta = tc.lloyd_prepare(t(x), 29)
        mine = tc.fused_lloyd_prepared(tops, t(y), **tmeta)
        plain = tc.fused_lloyd_pallas(t(x), t(y))
    for a, b in zip(mine, plain):
        assert torch.equal(a, b)


def test_lloyd_prepare_only_at_high_tier():
    x, _ = _data(9, m=10, nn=3, k=4)
    for tier, applies in (("default", False), ("high", True),
                          ("highest", False)):
        with tprec.scope(tier):
            ops, meta = tc.lloyd_prepare(t(x), 3)
        assert (ops is not None) == applies


def test_padded_rows_never_count():
    """Operand rows beyond m (garbage here) are never read: counts sum to
    m and match the labels."""
    x, y = _data(10, m=100, nn=7, k=6)
    with tprec.scope("high"):
        (xh, xl, xn), _ = tc.lloyd_prepare(t(x), 7)
        junk = torch.full((13, 6), 3e4).to(torch.bfloat16)
        ops = (torch.cat([xh, junk]), torch.cat([xl, junk]),
               torch.cat([xn, torch.full((1, 13), 1e9)], dim=1))
        sums, counts, val, idx = tc.fused_lloyd_prepared(ops, t(y), m=100)
        ref = tc.fused_lloyd_pallas(t(x), t(y))
    assert float(counts.sum()) == 100 and idx.shape == (100,)
    for a, b in zip((sums, counts, val, idx), ref):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_unsupported_device_raises_not_falls_back():
    """Only CPU tensors take the plain versions; any other device goes
    to a kernel or raises (here: the meta device)."""
    x = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tc.pairwise_pallas(x, x)


@pytest.mark.parametrize("m,n,k", [
    (1 << 20, 1024, 128), (1 << 20, 8192, 128), (1 << 20, 65536, 128),
    (1 << 20, 1 << 20, 512), (10_000_000, 4096, 256), (300, 1024, 128)])
def test_lloyd_plan(m, n, k):
    """The Lloyd pass's plan: the argmin grid is one block a
    multiprocessor, capped only by the row tiles, whatever the number of
    clusters; the scratch has no term in grid x n x k and does not change
    with the grid."""
    plan = tc._lloyd_plan(m, n, k)
    assert plan.grid == min(tc.LLOYD_SMS, -(-m // tc.TILE_M))
    assert plan.grid == tc._lloyd_plan(m, 1, k).grid
    assert tc._lloyd_plan(m, n, k, blocks=3).grid == min(3, plan.grid)
    for other in (tc._lloyd_plan(m, n, k, blocks=1),
                  tc._lloyd_plan(m, n, k, sms=1000)):
        assert other.scratch_bytes == plan.scratch_bytes
    # (chunk, cluster) counters within the budget unless one chunk holds
    # every row; then the sorted ids and the chunk warps' partials
    assert plan.row_chunks * n <= max(tc.LLOYD_HIST_ENTRIES, n)
    assert plan.row_chunks == -(-m // plan.row_chunk)
    assert plan.row_chunk >= tc.LLOYD_ROW_CHUNK
    bound = 4 * (max(tc.LLOYD_HIST_ENTRIES, n) + 2 * n + 1 + m
                 + (m // tc.LLOYD_SEG + 1) * k)
    assert plan.scratch_bytes <= bound
    with pytest.raises(ValueError):
        tc._lloyd_plan(m, n, k, blocks=0)


# ---------------------------------------------------------------------------
# csrc/fused_lloyd.cu's sums, emulated in plain torch
# ---------------------------------------------------------------------------


def _group_by_label(idx, m, n, plan):
    """The kernel's stable counting sort: warp w counts the labels of rows
    [w chunk, (w + 1) chunk) (labels outside [0, n) and rows >= m count
    nowhere), a scan over (label, chunk) gives each (label, chunk) its
    first slot, and the warp places its rows in order. Returns the
    cluster starts [n + 1] and the sorted row ids."""
    lab = idx[:m].long()
    valid = (lab >= 0) & (lab < n)
    hist = torch.zeros(plan.row_chunks, n, dtype=torch.int64)
    for w in range(plan.row_chunks):
        r0, r1 = w * plan.row_chunk, min(m, (w + 1) * plan.row_chunk)
        hist[w] = torch.bincount(lab[r0:r1][valid[r0:r1]], minlength=n)
    total = hist.sum(0)
    before = torch.cumsum(hist, 0) - hist            # chunks before ch
    start = torch.zeros(n + 1, dtype=torch.int64)
    start[1:] = torch.cumsum(total, 0)
    order = torch.full((int(start[-1]),), -1, dtype=torch.int64)
    cursor = before.clone()
    for w in range(plan.row_chunks):
        for r in range(w * plan.row_chunk, min(m, (w + 1) * plan.row_chunk)):
            if valid[r]:
                c = int(lab[r])
                order[start[c] + cursor[w, c]] = r
                cursor[w, c] += 1
    return start, order


def _sums_emulated(start, order, rows, n, seg):
    """Row groups sum a cluster's first ``seg`` sorted rows; chunk warp w
    sums the rows of [w seg, (w + 1) seg) at offset >= seg in the cluster
    holding entry w seg; the fix-up adds a long cluster's partials in
    chunk order. Returns the sums and how often each entry was summed."""
    k = rows.shape[1]
    sums = torch.zeros(n, k)
    seen = torch.zeros(order.numel(), dtype=torch.int64)
    for c in range(n):
        s, e = int(start[c]), int(start[c + 1])
        sums[c] = rows[order[s:min(e, s + seg)]].sum(0)
        seen[s:min(e, s + seg)] += 1
    n_chunks = rows.shape[0] // seg + 1
    part = torch.zeros(n_chunks, k)
    for w in range(n_chunks):
        first = w * seg
        if first >= int(start[n]):
            continue
        c = int(torch.searchsorted(start[:n], first, right=True)) - 1
        s, e = int(start[c]), int(start[c + 1])
        a, z = max(first, s + seg), min(first + seg, e)
        if a < z:
            part[w] = rows[order[a:z]].sum(0)
            seen[a:z] += 1
    for c in range(n):
        s, e = int(start[c]), int(start[c + 1])
        if e - s > seg:
            for q in range((s + seg) // seg, (e - 1) // seg + 1):
                sums[c] += part[q]
    return sums, seen


def _lloyd_case(name):
    """(x, y, m): operand rows past m are junk that must never count."""
    rng = np.random.default_rng(41)
    if name == "one_cluster_holds_every_row":
        x = rng.standard_normal((2500, 6)).astype(np.float32)
        y = np.concatenate([np.zeros((1, 6)), 50 + rng.standard_normal(
            (4, 6))]).astype(np.float32)
        return x, y, 2500
    if name == "empty_clusters":
        x = rng.standard_normal((1500, 5)).astype(np.float32)
        y = np.concatenate([rng.standard_normal((3, 5)), 100 + rng.uniform(
            size=(30, 5))]).astype(np.float32)
        return x, y, 1500
    # rows past m (junk) excluded; m not a multiple of the chunk
    x = rng.standard_normal((3000 + 40, 8)).astype(np.float32)
    x[3000:] = 1e4
    y = rng.standard_normal((21, 8)).astype(np.float32)
    return x, y, 3000


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("name", ["one_cluster_holds_every_row",
                                  "empty_clusters", "junk_rows_past_m"])
def test_lloyd_sums_emulated(name, tier):
    """The grouping and the chunked, in-order sums of csrc/fused_lloyd.cu,
    emulated from the plain version's labels: the sort is the stable sort
    by label, every labelled row is summed exactly once, the counts equal
    _lloyd_plain's exactly and the sums to 1e-5 of the cluster's |x|
    mass. The summed row is the tier's: hi + lo at 'high' (exact in f32),
    the bf16-rounded row at 'default', the f32 row at 'highest'."""
    x, y, m = _lloyd_case(name)
    xs, ys = tc._side(t(x), tier), tc._side(t(y), tier)
    nn, k = y.shape
    sums, counts, _, idx = tc._lloyd_plain(tier, xs, ys, m, nn, k)
    plan = tc._lloyd_plan(m, nn, k)
    assert m % plan.row_chunk and plan.row_chunks > 1
    start, order = _group_by_label(idx, m, nn, plan)
    assert torch.equal(order, torch.sort(idx[:m].long(), stable=True)[1])
    assert torch.equal(start[1:] - start[:-1], counts.long())
    rows = {"high": lambda: xs.v0.float() + xs.v1.float(),
            "default": lambda: tc._bf16_values(xs.v0),
            "highest": lambda: xs.v0}[tier]()
    got, seen = _sums_emulated(start, order, rows, nn, tc.LLOYD_SEG)
    assert torch.equal(seen, torch.ones_like(seen))
    mass = torch.zeros(nn, k).index_add_(0, idx[:m].long(), rows[:m].abs())
    assert bool(((got - sums).abs() <= 1e-5 * mass + 1e-6).all())
    if name == "one_cluster_holds_every_row":
        assert int(counts[0]) == m and int(start[1]) - int(start[0]) > \
            2 * tc.LLOYD_SEG
    if name == "empty_clusters":
        assert int((counts == 0).sum()) >= 20
        assert bool((got[counts == 0] == 0).all())
