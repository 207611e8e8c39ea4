"""The port's brute-force kNN (raft_tpu_torch/neighbors) against the
reference package's on the same numpy inputs, on all three routes of
``knn_plan``. On the CPU the port runs the plain versions of its kernels;
the reference runs its Pallas kernels in interpret mode.

Tolerance: both packages form the same products at each tier and differ
only in f32 accumulation order, so distances agree to 1e-5 of the
metric's magnitude (|q|² + |x|² for l2, 1 for cosine, |q||x| for inner),
and an index may differ only where the two candidates' exact distances
lie within that band (a near-tie). The dispatch plan must be identical.
"""

import itertools

import numpy as np
import pytest

import jax.numpy as jnp
from _torch_util import both_tiers, n, one_pass_cross, sq_norms, t
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import fused_topk as jft
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import fused_topk as tft
from raft_tpu_torch.neighbors import knn as t_knn

REL = 1e-5


def _data(seed, q=37, nn=700, d=19):
    rng = np.random.default_rng(seed)
    db = rng.standard_normal((nn, d)).astype(np.float32)
    db[min(50, nn - 1)] = db[7]               # tied pair: 7 must win
    queries = rng.standard_normal((q, d)).astype(np.float32)
    queries[0] = db[7] + 1e-3
    return queries, db


def _exact(metric, queries, db, cross=None):
    """f64 distances in the kernel vocabulary (l2 squared, cosine,
    -inner), of the exact or of a given cross product."""
    qq, xx = queries.astype(np.float64), db.astype(np.float64)
    cross = qq @ xx.T if cross is None else cross
    if metric == "l2":
        return sq_norms(qq)[:, None] - 2 * cross + sq_norms(xx)[None, :]
    if metric == "cosine":
        return 1 - cross / np.sqrt(np.outer(sq_norms(qq), sq_norms(xx)))
    return -cross


def _scale(metric, queries, db):
    if metric == "l2":
        return (sq_norms(queries)[:, None] + sq_norms(db)[None, :]).max(1)
    if metric == "cosine":
        return np.ones(len(queries))
    return np.sqrt(np.outer(sq_norms(queries), sq_norms(db))).max(1)


def _agree(got_v, got_i, want_v, want_i, exact, scale):
    """Indices equal except at near-ties; values within the band."""
    got_i, want_i = n(got_i), np.asarray(want_i)
    bad = np.argwhere(got_i != want_i)
    assert len(bad) <= max(1, got_i.size // 100), f"{len(bad)} differ"
    for r, c in bad:
        gap = abs(exact[r, got_i[r, c]] - exact[r, want_i[r, c]])
        assert gap <= REL * scale[r], (r, c, gap)
    fin = np.isfinite(np.asarray(want_v))
    np.testing.assert_array_equal(np.isfinite(n(got_v)), fin)
    err = np.abs(n(got_v) - np.asarray(want_v))[fin]
    assert (err <= (REL * scale[:, None] + 1e-6)
            .repeat(want_i.shape[1], 1)[fin]).all()


@pytest.mark.parametrize("metric", ["l2", "cosine", "inner"])
@pytest.mark.parametrize("tier", ["default", "high", "highest"])
def test_knn_fused_matches_reference(tier, metric):
    """The fused distance + top-k kernel's function at every tier and
    metric; a NaN query row gets no candidate ((+inf, 0) throughout).

    At 'default' the port makes one bf16 pass, as on the TPU, while the
    reference on the CPU computes f32 there (see test_torch_contractions):
    the port is held to the exact top-k of a numpy emulation of that pass,
    and its distances only to 1e-2 of the reference's."""
    queries, db = _data(1)
    queries[5] = np.nan
    with both_tiers(tier):
        jv, ji = jft.knn_fused(jnp.asarray(queries), jnp.asarray(db), 10,
                               metric)
        tv, ti = tft.knn_fused(t(queries), t(db), 10, metric)
    assert n(ti)[5].tolist() == [0] * 10 and np.isinf(n(tv)[5]).all()
    live = np.ones(len(queries), bool)
    live[5] = False
    scale = _scale(metric, queries, db)[live]
    jv, ji = np.asarray(jv)[live], np.asarray(ji)[live]
    tv, ti = n(tv)[live], n(ti)[live]
    if tier == "default":
        err = np.abs(tv - jv)
        assert (err <= 1e-2 * scale[:, None]).all()
        d = _exact(metric, queries, db, one_pass_cross(queries, db))[live]
        ji = np.argsort(d, axis=1, kind="stable")[:, :10]
        jv = np.take_along_axis(d, ji, 1)
    else:
        d = _exact(metric, queries, db)[live]
    _agree(tv, ti, jv, ji, d, scale)
    if metric == "l2":
        assert int(n(ti)[0, 0]) == 7


def test_knn_fused_validates_the_tile_knobs():
    queries, db = _data(2, q=4, nn=300, d=3)
    with pytest.raises(ValueError):
        tft.knn_fused(t(queries), t(db), 3, tn=1024, sw=384)
    with pytest.raises(ValueError):
        tft.knn_fused(t(queries), t(db), 300)


# (n_db, k, tile) reaching each route for a few queries: fused, radix
# (one and two chunks) and scan
ROUTES = {
    "fused": (700, 10, None),
    "radix": (16500, 300, None),
    "radix_chunks": (20000, 300, 16384),
    "scan": (1200, 300, None),
    "scan_tiles": (1200, 20, 64),
}


@pytest.mark.parametrize("metric", ["euclidean", "inner"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_knn_matches_reference(route, metric):
    nn, k, tile = ROUTES[route]
    queries, db = _data(3, q=4, nn=nn, d=8)
    want_path = route.split("_")[0]
    assert tbf.knn_plan(4, nn, k, metric, tile) == \
        jbf.knn_plan(4, nn, k, metric, tile)
    assert tbf.knn_plan(4, nn, k, metric, tile)[0] == want_path
    with both_tiers("high"):
        jv, ji = jbf.knn(None, db, queries, k, metric=metric, tile=tile)
        tv, ti = t_knn(_cpu(), t(db), t(queries), k, metric=metric,
                       tile=tile)
    kmetric = "l2" if metric == "euclidean" else "inner"
    exact = _exact(kmetric, queries, db)
    scale = _scale(kmetric, queries, db)
    if metric == "euclidean":                 # rooted: compare squares
        _agree(n(tv) ** 2, ti, np.asarray(jv) ** 2, ji, exact, 2 * scale)
    else:                                     # similarity: compare -vals
        _agree(-n(tv), ti, -np.asarray(jv), ji, exact, scale)
    assert str(ti.dtype) == "torch.int32"


def _cpu():
    import raft_tpu_torch as rt

    return rt.device_resources("cpu")


@pytest.mark.parametrize("metric", ["l2", "euclidean", "cosine", "inner",
                                    "l1"])
@pytest.mark.parametrize("tile", [None, 64, 128, 4096])
def test_knn_plan_matches_reference(metric, tile):
    for q, nn, k in itertools.product(
            (1, 8, 4096, 70000), (500, 16384, 20000, 1 << 20, 3_000_000),
            (1, 64, 256, 257, 512, 1024, 2048, 20000)):
        assert tbf.knn_plan(q, nn, k, metric, tile) == \
            jbf.knn_plan(q, nn, k, metric, tile), (q, nn, k)
    assert tbf.knn_plan(8, 20000, 64, metric, tile, vma_blocked=True) == \
        jbf.knn_plan(8, 20000, 64, metric, tile, vma_blocked=True)
    assert tbf.knn_plan(8, 20000, 64, n_lists=10, nprobe=3, pq=True) == \
        jbf.knn_plan(8, 20000, 64, n_lists=10, nprobe=3, pq=True)


def test_knn_rejects_what_is_not_ported():
    queries, db = _data(4, q=3, nn=40, d=4)
    with pytest.raises(ValueError):
        t_knn(None, t(db), t(queries), 41)
    with pytest.raises(ValueError):
        t_knn(None, t(db), t(queries), 3, metric="mahalanobis")


@pytest.mark.parametrize("metric", ["l1", "linf", "canberra"])
def test_knn_unexpanded_small_matches_reference(metric):
    """The l1 call that raised until the unexpanded tile was ported, and
    its siblings: indices equal to the reference's (no near-ties in this
    normal data at these sizes), distances within 1e-5 * sqrt(d)."""
    queries, db = _data(4, q=3, nn=40, d=4)
    jv, ji = jbf.knn(None, db, queries, 3, metric=metric)
    tv, ti = t_knn(_cpu(), t(db), t(queries), 3, metric=metric)
    np.testing.assert_array_equal(n(ti), np.asarray(ji))
    np.testing.assert_allclose(n(tv), np.asarray(jv), rtol=2e-5)


@pytest.mark.parametrize("tier", ["default", "high", "highest"])
def test_minonly_probe_matches_reference(tier):
    """The tune-only 1-NN floor probe (finite inputs). At 'high' and
    'highest' both packages form the same products, so indices are equal
    (ties go to the smaller column) and values agree to 1e-5 of
    |q|² + |x|². At 'default' the port makes one bf16 pass, as on the TPU,
    while the reference on the CPU computes f32: the port's indices equal
    the exact argmin of a numpy emulation of that pass, and its values
    agree with the reference's to 1e-2 of the scale."""
    rng = np.random.default_rng(14)
    q = rng.normal(size=(21, 10)).astype(np.float32)
    db = rng.normal(size=(900, 10)).astype(np.float32)
    db[700] = db[3]                               # tie: column 3 first
    q[0] = db[3] + 1e-3
    with both_tiers(tier):
        jv, ji = jft._minonly_probe(jnp.asarray(q), jnp.asarray(db),
                                    tm=128, tn=256)
        tv, ti = tft._minonly_probe(t(q), t(db), tm=128, tn=256)
    scale = _scale("l2", q, db)
    assert int(n(ti)[0]) == 3
    if tier == "default":
        d = _exact("l2", q, db, one_pass_cross(q, db))
        np.testing.assert_array_equal(n(ti), np.argmin(d, axis=1))
        assert (np.abs(n(tv) - np.asarray(jv)) <= 1e-2 * scale).all()
        return
    np.testing.assert_array_equal(n(ti), np.asarray(ji))
    assert (np.abs(n(tv) - np.asarray(jv)) <= REL * scale).all()
