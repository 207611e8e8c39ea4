"""The port's stats layer (raft_tpu_torch.stats) against the reference
package on the same seeded numpy inputs, CPU tensors on the port's side
(the silhouette's keyed sums run ``csr_spmm.cu``'s plain version, the
distances ``unexpanded_tile.cu``'s, trustworthiness's top-k
``topk_insert.cu``'s).

Tolerances:

- exact: the histogram on every route the reference takes (at most 512
  bins, at most 2^14, more; a binner; out-of-range, NaN and infinite
  values), the contingency table, and the raise on a class count that
  is too small;
- 1e-12 relative, in f64: the closed-form clustering scores, the
  information measures, the regression metrics and the moments (on f64
  data; ``cov`` at each tier, whose f64 product is exact at every tier);
- within ``REL`` (1e-5, two f32 summation orders): ``silhouette_score``
  at each tier on 150 rows in chunks of 64 (the last chunk ragged), and
  ``trustworthiness_score`` with batches of 48 of 150 rows. The
  reference's silhouette is computed once, at 'high': on the CPU it
  gives the same value at every tier (XLA:CPU takes its one-hot product
  in f32 at every precision), and each compile of its interpreted
  distance kernel costs seconds.
"""

import numpy as np
import pytest
import torch

from _torch_util import TIERS, both_tiers, n, t
from raft_tpu import stats as rs
from raft_tpu_torch import device_resources
from raft_tpu_torch import stats as ts

RES = device_resources("cpu")
REL = 1e-5


def _rng(seed=3):
    return np.random.default_rng(seed)


def _close(got, want, rtol=1e-12, atol=0.0):
    g = n(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                               rtol=rtol, atol=atol)


def _same(got, want):
    g, w = n(got), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


# -- moments -----------------------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1])
def test_moments_f64(axis):
    x = _rng().normal(2.0, 3.0, (40, 7))
    mu = x.mean(axis)
    for name in ("mean", "sum_"):
        _close(getattr(ts, name)(t(x), axis), getattr(rs, name)(x, axis))
    for sample in (True, False):
        _close(ts.vars_(t(x), axis=axis, sample=sample),
               rs.vars_(x, axis=axis, sample=sample))
        _close(ts.vars_(t(x), mu=t(mu), axis=axis, sample=sample),
               rs.vars_(x, mu=mu, axis=axis, sample=sample))
        _close(ts.stddev(t(x), axis=axis, sample=sample),
               rs.stddev(x, axis=axis, sample=sample))
        for got, want in zip(ts.meanvar(t(x), axis, sample),
                             rs.meanvar(x, axis, sample)):
            _close(got, want)
    _close(ts.mean_center(t(x), axis=axis), rs.mean_center(x, axis=axis),
           atol=1e-14)
    _close(ts.mean_add(t(x), t(mu), axis), rs.mean_add(x, mu, axis))
    for kw in ({}, dict(rows=9), dict(row_ids=np.array([4, 0, 17, 33]))):
        tkw = {k: (t(v) if k == "row_ids" else v) for k, v in kw.items()}
        for got, want in zip(ts.minmax(t(x), axis, **tkw),
                             rs.minmax(x, axis, **kw)):
            _same(got, want)


def test_integer_sums_and_means():
    x = _rng().integers(-50, 50, (30, 4)).astype(np.int32)
    _close(ts.mean(t(x)), rs.mean(x), rtol=1e-6)        # an f32 mean
    assert ts.mean(t(x)).dtype == torch.float32
    assert ts.mean(t(x.astype(np.int64))).dtype == torch.float64
    _close(ts.sum_(t(x), 1), rs.sum_(x, 1))


@pytest.mark.parametrize("tier", TIERS)
def test_cov_f64_at_each_tier(tier):
    x = _rng(4).normal(size=(60, 5))
    mu = x.mean(0) + 0.1
    for kw in ({}, dict(sample=False), dict(center=False)):
        with both_tiers(tier):
            _close(ts.cov(t(x), **kw), rs.cov(x, **kw), atol=1e-14)
    with both_tiers(tier):
        _close(ts.cov(t(x), t(mu)), rs.cov(x, mu), atol=1e-14)


@pytest.mark.parametrize("tier", TIERS)
def test_cov_f32_within_rel(tier):
    """f32 data: each tier's product within REL of an f64 covariance
    over |xc|ᵀ|xc| (bf16 for 'default', 2^-8 an operand)."""
    x = _rng(5).normal(size=(300, 6)).astype(np.float32)
    xc = x.astype(np.float64) - x.astype(np.float64).mean(0)
    want = xc.T @ xc / 299
    mass = np.abs(xc).T @ np.abs(xc) / 299
    with both_tiers(tier):
        got = n(ts.cov(t(x))).astype(np.float64)
    rel = 1e-2 if tier == "default" else REL
    assert (np.abs(got - want) <= rel * mass + 1e-7).all()


def test_weighted_means_f64():
    x = _rng(6).normal(size=(25, 8))
    wr = _rng(7).uniform(0.1, 2.0, 25)
    wc = _rng(8).uniform(0.1, 2.0, 8)
    _close(ts.weighted_mean(t(x), t(wr), 0), rs.weighted_mean(x, wr, 0))
    _close(ts.col_weighted_mean(t(x), t(wr)), rs.col_weighted_mean(x, wr))
    _close(ts.row_weighted_mean(t(x), t(wc)), rs.row_weighted_mean(x, wc))


# -- histogram ----------------------------------------------------------------

@pytest.mark.parametrize("n_bins", [1, 37, 512, 513, 3000, 1 << 14,
                                    (1 << 14) + 1, 20000])
def test_histogram_exact_on_every_reference_route(n_bins):
    """Up to 512 bins the reference takes its one-hot sum, up to 2^14 its
    factored contraction, beyond its scatter; values a few bins either
    side of the range are dropped."""
    data = _rng(n_bins).integers(-3, n_bins + 3, (700, 3)).astype(
        np.float32)
    _same(ts.histogram(t(data), n_bins), rs.histogram(data, n_bins))


def test_histogram_hist_types_and_one_column():
    data = _rng(9).integers(0, 40, 300)
    for ht in ts.HistType:
        _same(ts.histogram(t(data), 40, hist_type=ht),
              rs.histogram(data, 40, hist_type=rs.HistType[ht.name]))
        assert ht.value == rs.HistType[ht.name].value
    with pytest.raises(ValueError):
        ts.histogram(t(data), 40, hist_type="gmem")


def test_histogram_binner_and_non_finite_values():
    """NaN, inf and values past int32 fall outside every bin. The
    reference's identity binner casts a numpy array in numpy, which
    drops them; its binner route casts in XLA, which puts a NaN in bin
    0, so there the port is held to the reference's result with the NaN
    given as -inf (ROADMAP.md, "Deliberate divergences")."""
    data = _rng(10).uniform(-1.0, 1.0, (500, 4)).astype(np.float32)
    data[3, 0], data[7, 1], data[9, 2] = np.nan, np.inf, -np.inf
    data[11, 3], data[12, 3] = 3e9, -3e9

    def binner(v, r, c):
        return (v + 1.0) * 50.0 + 100.0 * c

    no_nan = np.where(np.isnan(data), -np.inf, data)
    for n_bins in (300, 4000):
        _same(ts.histogram(t(data), n_bins, binner=binner),
              rs.histogram(no_nan, n_bins, binner=binner))
    _same(ts.histogram(t(data), 3), rs.histogram(data, 3))
    _same(ts.histogram(torch.zeros(0, 3), 1000),
          rs.histogram(np.zeros((0, 3), np.float32), 1000))


# -- information --------------------------------------------------------------

def test_information_f64():
    labels = _rng(11).integers(2, 9, 400)
    _close(ts.entropy(t(labels)), rs.entropy(labels))
    _close(ts.entropy(t(labels), 2, 12), rs.entropy(labels, 2, 12))
    p = _rng(12).dirichlet(np.ones(10))
    q = _rng(13).dirichlet(np.ones(10))
    p[3] = 0.0
    _close(ts.kl_divergence(t(p), t(q)), rs.kl_divergence(p, q))
    ll = _rng(14).normal(-100.0, 5.0, 6)
    for ic in ts.IC_Type:
        want = rs.information_criterion_batched(ll, rs.IC_Type[ic.name], 4,
                                                50)
        _close(ts.information_criterion_batched(t(ll), ic, 4, 50), want)
        _close(ts.information_criterion(t(ll[:1]), ic, 4, 50),
               rs.information_criterion(ll[:1], rs.IC_Type[ic.name], 4, 50))
    c = _rng(15).normal(size=(6, 3))
    sizes = _rng(16).integers(1, 40, 6)
    _close(ts.cluster_dispersion(t(c), t(sizes)),
           rs.cluster_dispersion(c, sizes))
    _close(ts.cluster_dispersion(t(c), t(sizes), 300),
           rs.cluster_dispersion(c, sizes, 300))


def test_regression_metrics_f64():
    for size in (31, 32):
        y = _rng(size).normal(size=size)
        yh = y + _rng(size + 1).normal(0.0, 0.3, size)
        for got, want in zip(ts.regression_metrics(t(yh), t(y)),
                             rs.regression_metrics(yh, y)):
            _close(got, want)
        _close(ts.r2_score(t(y), t(yh)), rs.r2_score(y, yh))
    a = _rng(3).integers(0, 4, 90)
    b = np.where(_rng(4).random(90) < 0.7, a, 0)
    _close(ts.accuracy(t(a), t(b)), rs.accuracy(a, b))


# -- clustering scores --------------------------------------------------------

def _label_pairs():
    rng = _rng(17)
    truth = rng.integers(0, 6, 500)
    noisy = np.where(rng.random(500) < 0.8, truth, rng.integers(0, 9, 500))
    zeros = np.zeros(500, int)
    return [(truth, noisy), (truth, truth), (truth, zeros), (zeros, zeros)]


@pytest.mark.parametrize("pair", range(4))
def test_clustering_scores_f64(pair):
    a, b = _label_pairs()[pair]
    _same(ts.contingency_matrix(t(a), t(b)), rs.contingency_matrix(a, b))
    for name in ("rand_index", "adjusted_rand_index", "mutual_info_score",
                 "homogeneity_score", "completeness_score", "v_measure"):
        got = getattr(ts, name)(t(a), t(b))
        want = getattr(rs, name)(a, b)
        assert got.dtype == torch.float64
        _close(got, want, atol=1e-15)
    k = int(max(a.max(), b.max())) + 1
    _close(ts.adjusted_rand_index(t(a), t(b), k),
           rs.adjusted_rand_index(a, b, k), atol=1e-15)
    _close(ts.v_measure(t(a), t(b), k, beta=0.5),
           rs.v_measure(a, b, k, beta=0.5), atol=1e-15)


def test_contingency_with_class_counts_and_raise():
    a = np.array([0, 1, 2, 2, 1, 0, 3])
    b = np.array([1, 1, 0, 0, 2, 2, 2])
    _same(ts.contingency_matrix(t(a), t(b), 6, 4),
          rs.contingency_matrix(a, b, 6, 4))
    with pytest.raises(ValueError):
        rs.contingency_matrix(a, b, 3, 4)
    with pytest.raises(ValueError):
        ts.contingency_matrix(t(a), t(b), 3, 4)
    with pytest.raises(ValueError):
        ts.contingency_matrix(t(a), t(b), 4, 2)
    with pytest.raises(ValueError):
        ts.rand_index(t(a), t(b), 3)


# -- silhouette and neighborhood scores ---------------------------------------

def _blobs(seed, m=150, d=5, k=4):
    rng = _rng(seed)
    centers = rng.normal(0.0, 4.0, (k, d))
    lab = rng.integers(0, k, m)
    x = (centers[lab] + rng.normal(size=(m, d))).astype(np.float32)
    return x, lab.astype(np.int32)


@pytest.fixture(scope="module")
def silhouette_case():
    """150 rows in 4 blobs, a cluster of one point and an empty one;
    the reference's score at 'high' in chunks of 64."""
    x, lab = _blobs(18)
    lab[5] = 4
    with both_tiers("high"):
        want = float(rs.silhouette_score(None, x, lab, 6, chunk=64))
    return x, lab, want


@pytest.mark.parametrize("tier", TIERS)
def test_silhouette_within_rel_at_each_tier(tier, silhouette_case):
    x, lab, want = silhouette_case
    with both_tiers(tier):
        got = ts.silhouette_score(RES, t(x), t(lab), 6, chunk=64)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= REL * max(1.0, abs(want))


def test_silhouette_l1_in_one_chunk():
    from raft_tpu.distance import DistanceType as RD
    from raft_tpu_torch.distance import DistanceType as TD

    x, lab = _blobs(19, m=90)
    want = float(rs.silhouette_score(None, x, lab, 4, metric=RD.L1))
    got = float(ts.silhouette_score(RES, t(x), t(lab), 4, metric=TD.L1))
    assert abs(got - want) <= REL * max(1.0, abs(want))


def test_trustworthiness_within_rel(n_neighbors=5):
    x, _ = _blobs(20, d=8)
    proj = _rng(21).normal(size=(8, 2)).astype(np.float32)
    emb = (x @ proj).astype(np.float32)
    want = float(rs.trustworthiness_score(None, x, emb, n_neighbors,
                                          batch_size=48))
    got = ts.trustworthiness_score(RES, t(x), t(emb), n_neighbors,
                                   batch_size=48)
    assert got.dtype == torch.float64
    assert abs(float(got) - want) <= REL
    same = float(ts.trustworthiness_score(RES, t(x), t(x), n_neighbors,
                                          batch_size=48))
    assert same == 1.0


def test_neighborhood_recall_f64():
    rng = _rng(22)
    ref = np.stack([rng.permutation(30)[:6] for _ in range(20)])
    idx = ref.copy()
    idx[::3, 0] = 40 + np.arange(7)          # misses
    dist = rng.uniform(0.0, 1.0, (20, 6))
    rdist = dist.copy()
    rdist[::6, 0] = dist[::6, 0] + 5e-5     # misses tied within eps
    _close(ts.neighborhood_recall(t(idx), t(ref)),
           rs.neighborhood_recall(idx, ref))
    _close(ts.neighborhood_recall(t(idx), t(ref), t(dist), t(rdist)),
           rs.neighborhood_recall(idx, ref, dist, rdist))
    _close(ts.neighborhood_recall(t(idx), t(ref), t(dist), t(rdist), 1e-6),
           rs.neighborhood_recall(idx, ref, dist, rdist, 1e-6))
