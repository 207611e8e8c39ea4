"""The plan and operands of the fused top-k and the 1-NN probe
(raft_tpu_torch/neighbors/fused_topk.py) on the CPU.

The CUDA kernels (csrc/fused_topk.cu, csrc/minonly.cu) cut the database
into splits, select within each and merge the splits' lists; on the
wgmma route they read bf16 operands padded to a depth of a multiple of 8.
These tests hold the pieces the kernels rely on: the split plan covers
every tile once with no empty split; the plain versions, run split by
split over the plan's column ranges and merged as the kernels merge, are
bit for bit one plain call (so the kernels may choose their splits); the
plain versions give bit for bit the same result on the padded operands;
and the route table sends 'highest' to the FMA tile and the other tiers
to the wgmma tile. The kernels themselves are held against the plain
versions on the card (tests/test_torch_kernels.py) and against the
reference package in tests/test_torch_knn.py.
"""

import types

import numpy as np
import pytest
import torch

from raft_tpu_torch.linalg import contractions as tc
from raft_tpu_torch.neighbors import fused_topk as tft
from raft_tpu_torch.util.math import cdiv

TIERS = ("default", "high", "highest")
EDGE = 4 * tc.TILE_N       # a split edge of 2 and of 8 splits of 1000 rows
SMS = 132                  # multiprocessors of an H100 SXM


def _walk(plan, m, n):
    """The split walk's (row tile, column tile) visits, block by block."""
    row_tiles, n_tiles = cdiv(m, tc.TILE_M), cdiv(n, tc.TILE_N)
    seen = []
    for b in range(plan.grid):
        for u in range(b, plan.units, plan.grid):
            rt, s = divmod(u, plan.splits)
            t0 = s * plan.tiles_per_split
            t1 = min(n_tiles, t0 + plan.tiles_per_split)
            assert t1 > t0, "empty split"
            seen += [(rt, ct) for ct in range(t0, t1)]
    assert sorted(seen) == [(r, c) for r in range(row_tiles)
                            for c in range(n_tiles)]
    return seen


@pytest.mark.parametrize("m,n,k", [
    (4096, 1 << 20, 64), (4096, 1 << 20, 256), (4096, 1 << 20, 1),
    (256, 1 << 20, 64), (300, 1100, 50), (517, 3001, 256), (517, 100, 256),
    (1, 1 << 20, 256), (1, 1, 1), (70000, 3_000_000, 16)])
def test_split_plan_covers_every_tile_once(m, n, k):
    """Every split holds at least one column tile, the units cover every
    (row tile, column tile) exactly once, the grid is one block a
    multiprocessor but never more than the units, the scratch is the
    split lists' keys, and no smaller split count keeps the busiest
    block within the slack of the best."""
    plan = tft._split_plan(m, n, k, SMS)
    row_tiles, n_tiles = cdiv(m, tc.TILE_M), cdiv(n, tc.TILE_N)
    assert plan.splits == cdiv(n_tiles, plan.tiles_per_split)
    assert plan.units == row_tiles * plan.splits
    assert plan.grid == min(SMS, plan.units)
    assert plan.scratch_bytes == 8 * plan.splits * m * k
    assert plan.splits * k * 8 <= tft.MERGE_BYTES
    if plan.units <= 4 * SMS:
        _walk(plan, m, n)

    def busiest(s):
        s, tps = tc._whole_splits(n_tiles, s)
        return cdiv(row_tiles * s, SMS) * tps

    tried = range(1, min(n_tiles, tft.MERGE_BYTES // (8 * k),
                         SMS) + 1)
    best = min(busiest(s) for s in tried)
    assert busiest(plan.splits) <= best * (1 + tc.PLAN_SLACK)
    assert all(busiest(s) > best * (1 + tc.PLAN_SLACK)
               for s in tried if s < plan.splits)


def test_split_plan_at_the_knn_shapes():
    """At the kNN shape (4096 queries, 2^20 rows) four splits fill 128
    of 132 multiprocessors with one unit each; 256 queries take 63
    splits; the k = 256 scratch is 32 MB (the FMA grid's 33 splits take
    277 MB); a test's split count is honoured, cut to whole splits."""
    plan = tft._split_plan(4096, 1 << 20, 256, SMS)
    assert (plan.splits, plan.tiles_per_split, plan.units, plan.grid) == \
        (4, 2048, 128, 128)
    assert plan.scratch_bytes == 32 << 20
    assert tft._split_plan(256, 1 << 20, 64, SMS).splits == 63
    assert tft._fma_splits(4096, 1 << 20) == 33
    forced = tft._split_plan(300, 1100, 50, SMS, splits=7)
    assert (forced.splits, forced.tiles_per_split) == (5, 2)
    _walk(forced, 300, 1100)
    assert tft._split_plan(300, 1100, 50, 3).grid == 3
    _walk(tft._split_plan(300, 1100, 50, 3), 300, 1100)
    with pytest.raises(ValueError):
        tft._split_plan(0, 10, 1, SMS)


def _data(seed, m, n, kd):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, kd)).astype(np.float32)
    y = rng.standard_normal((n, kd)).astype(np.float32)
    y[EDGE] = y[3]                     # ties across a split edge: the
    y[EDGE + 1] = y[EDGE - 1]          # smaller column first
    x[0] = y[3] + 1e-3
    x[1] = y[EDGE - 1]
    x[4] = np.nan                      # no candidate at all
    y[40] = np.nan                     # never a candidate
    return torch.from_numpy(x), torch.from_numpy(y)


def _cols(side, c0, c1):
    return tc.Side(side.v0[c0:c1], None if side.v1 is None else
                   side.v1[c0:c1], side.norms[c0:c1])


def _merge_lists(parts, k):
    """The k smallest (value, column) keys of the split lists, as the
    kernels' merge takes them: -0.0 equal to +0.0, the column deciding,
    empty slots (+inf, 0)."""
    v = torch.cat([p[0] for p in parts], 1)
    i = torch.cat([p[1] for p in parts], 1)
    o = torch.sort(i, dim=1, stable=True).indices
    v, i = v.gather(1, o), i.gather(1, o)
    o = torch.sort(torch.where(v == 0, torch.zeros_like(v), v), dim=1,
                   stable=True).indices[:, :k]
    return v.gather(1, o), i.gather(1, o)


def _bitwise(a, b):
    return all(torch.equal(p.view(torch.int32), q.view(torch.int32))
               for p, q in zip(a, b))


@pytest.mark.parametrize("splits", [2, 8])
@pytest.mark.parametrize("metric", ["l2", "cosine", "inner"])
@pytest.mark.parametrize("tier", TIERS)
def test_plain_split_by_split_equals_one_call(tier, metric, splits):
    """The fused top-k's plain version over each split's columns of the
    plan, merged, is bit for bit one plain call, at two split counts,
    with a tie across a split edge, a NaN row and a NaN column; the
    probe's plain version folded over the splits in order (the earlier
    split wins ties) likewise."""
    m, n, kd, k = 37, 1000, 13, 20
    x, y = _data(7, m, n, kd)
    xs, ys = tc._side(x, tier), tc._side(y, tier)
    plan = tft._split_plan(m, n, k, SMS, splits=splits)
    assert plan.splits == splits
    edges = [min(n, s * plan.tiles_per_split * tc.TILE_N)
             for s in range(plan.splits + 1)]
    parts, best = [], None
    for c0, c1 in zip(edges, edges[1:]):
        sv, si = tft._fused_topk_plain(tier, metric, xs, _cols(ys, c0, c1),
                                       m, c1 - c0, kd, k)
        parts.append((sv, torch.where(torch.isfinite(sv), si + c0, 0)))
        if metric == "l2":
            pv, pi = tft._minonly_plain(tier, xs, _cols(ys, c0, c1), m,
                                        c1 - c0, kd)
            pi = torch.where(torch.isfinite(pv), pi + c0, 0)
            if best is None:
                best = pv, pi
            else:
                better = pv < best[0]
                best = (torch.where(better, pv, best[0]),
                        torch.where(better, pi, best[1]))
    want = tft._fused_topk_plain(tier, metric, xs, ys, m, n, kd, k)
    assert _bitwise(_merge_lists(parts, k), want)
    assert want[1][4].tolist() == [0] * k
    if metric == "l2":
        assert want[1][0, :2].tolist() == [3, EDGE]
        assert want[1][1, :2].tolist() == [EDGE - 1, EDGE + 1]
        one = tft._minonly_plain(tier, xs, ys, m, n, kd)
        assert _bitwise(best, one)
        assert int(one[1][0]) == 3 and int(one[1][4]) == 0


@pytest.mark.parametrize("kd", [37, 45])
@pytest.mark.parametrize("tier", ["default", "high"])
def test_plain_on_wgmma_operands_equals_unpadded(tier, kd):
    """The wgmma route's operands (bf16 rows, depth padded with zero
    columns to a multiple of 8) give the plain versions bit for bit the
    unpadded result: the zero columns add exact zeros."""
    m, n, k = 29, 600, 16
    x, y = _data(8, m, n, kd)
    xs, ys = tc._side(x, tier), tc._side(y, tier)
    ws, vs, kp = tc._wgmma_operands(tier, xs, ys, m, n, kd)
    assert kp % tc.WGMMA_DEPTH == 0 and kp > kd
    assert ws.v0.dtype == vs.v0.dtype == torch.bfloat16
    for metric in ("l2", "cosine", "inner"):
        assert _bitwise(
            tft._fused_topk_plain(tier, metric, ws, vs, m, n, kp, k),
            tft._fused_topk_plain(tier, metric, xs, ys, m, n, kd, k))
    assert _bitwise(tft._minonly_plain(tier, ws, vs, m, n, kp),
                    tft._minonly_plain(tier, xs, ys, m, n, kd))


@pytest.mark.parametrize("tier", TIERS)
def test_route_table_chooses_the_tile(tier, monkeypatch):
    """'highest' goes to the FMA tile with f32 operands and its own grid
    of query tiles x splits; 'default' and 'high' to the wgmma tile with
    bf16 operands padded to a depth of a multiple of 8 and the split
    plan's splits and persistent grid."""
    assert tft.ROUTE == {"default": "wgmma", "high": "wgmma",
                         "highest": "fma"}
    props = types.SimpleNamespace(multi_processor_count=SMS)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: props)
    m, n, kd, k = 300, 5000, 45, 64
    x, y = _data(9, m, n, kd)
    xs, ys = tc._side(x, tier), tc._side(y, tier)
    ws, vs, kp, splits, grid = tft._launch_plan(tier, xs, ys, m, n, kd, k,
                                                None)
    if tier == "highest":
        assert (ws, vs, kp) == (xs, ys, kd)
        assert (splits, grid) == (tft._fma_splits(m, n), 0)
        return
    plan = tft._split_plan(m, n, k, SMS)
    assert (kp, splits, grid) == (48, plan.splits, plan.grid)
    assert ws.v0.dtype == torch.bfloat16 and ws.v0.shape[1] == 48
    assert tft._launch_plan(tier, xs, ys, m, n, kd, k, 3)[3] == 3
