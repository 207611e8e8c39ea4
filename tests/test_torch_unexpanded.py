"""The port's unexpanded metrics (the family with no GEMM form) against the
reference package's: ``pairwise_unexpanded_pallas`` (the reference's
Pallas tile, interpreted here; the port's plain version, which sums each
output depth by depth in order as its CUDA kernel does),
``pairwise_distance`` over all 20 metrics, and ``knn`` with the
unexpanded metrics on its radix and scan routes.

Tolerance: every term of these metrics is >= 0, so an output is its own
mass; two f32 summation orders agree to 1e-5 * sqrt(k) of it. Integer-
valued inputs make l1, linf and hamming exact in any order, and there the
outputs must be equal, and so must kNN indices (ties to the smaller
index in both packages).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import raft_tpu_torch as rt
from _torch_util import both_tiers, n, t
from raft_tpu.distance import DistanceType as JDT
from raft_tpu.distance import pairwise_distance as j_pd
from raft_tpu.linalg import contractions as jc
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu_torch.distance import DistanceType as TDT
from raft_tpu_torch.distance import pairwise_distance as t_pd
from raft_tpu_torch.linalg import contractions as tc
from raft_tpu_torch.neighbors import brute_force as tbf

CPU = rt.device_resources("cpu")
METRICS = ("l1", "linf", "canberra", "lp", "hamming", "l2un")
EXACT_ON_INTEGERS = ("l1", "linf", "hamming")


def _rel(k: int) -> float:
    return 1e-5 * np.sqrt(k)


def _inputs(seed, m, nn, k, integer):
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-4, 5, (m, k)).astype(np.float32)
        y = rng.integers(-4, 5, (nn, k)).astype(np.float32)
    else:
        x = rng.standard_normal((m, k)).astype(np.float32)
        y = rng.standard_normal((nn, k)).astype(np.float32)
        y[: nn // 4] = np.round(y[: nn // 4])     # some exact matches
    return x, y


def _close(got, want, k, exact=False):
    got, want = n(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    fin = np.isfinite(want)
    err = np.abs(got - want)[fin]
    assert (err <= _rel(k) * np.abs(want[fin]) + 1e-6).all(), err.max()


@pytest.mark.parametrize("shape", [(37, 45, 19), (9, 300, 70)],
                         ids=["37x45x19", "9x300x70"])
@pytest.mark.parametrize("integer", [True, False], ids=["int", "normal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", METRICS)
def test_unexpanded_matches_reference(metric, dtype, integer, shape):
    m, nn, k = shape
    x, y = _inputs(7, m, nn, k, integer)
    jx, jy = jnp.asarray(x, dtype), jnp.asarray(y, dtype)
    p = 3.0 if metric == "lp" else 2.0
    want = jc.pairwise_unexpanded_pallas(jx, jy, metric, p)
    tx, ty = t(x).to(getattr(torch, dtype)), t(y).to(getattr(torch, dtype))
    got = tc.pairwise_unexpanded_pallas(tx, ty, metric, p)
    assert got.dtype == torch.float32
    _close(got, want, k, exact=integer and metric in EXACT_ON_INTEGERS)


def test_unexpanded_zero_nan_inf_rows():
    """canberra: 0/0 gives 0 and a NaN denominator gives 0; linf: a NaN
    propagates through the max; l1: NaN and inf as IEEE gives them."""
    x = np.zeros((4, 5), np.float32)
    x[1, 2] = np.nan
    x[2, 0] = np.inf
    x[3] = [1, -2, 0, 4, 0]
    y = np.zeros((3, 5), np.float32)
    y[1] = [1, 2, 0, -4, 0]
    y[2, 2] = np.inf
    for metric in METRICS:
        want = np.asarray(jc.pairwise_unexpanded_pallas(
            jnp.asarray(x), jnp.asarray(y), metric))
        got = n(tc.pairwise_unexpanded_pallas(t(x), t(y), metric))
        np.testing.assert_array_equal(got, want, err_msg=metric)
    canberra = n(tc.pairwise_unexpanded_pallas(t(x), t(y), "canberra"))
    assert canberra[0, 0] == 0.0 and canberra[1, 0] == 0.0
    assert np.isnan(n(tc.pairwise_unexpanded_pallas(t(x), t(y),
                                                    "linf"))[1]).all()


def test_unexpanded_f64_stays_f64_and_knobs_choose_nothing():
    x, y = _inputs(8, 6, 7, 33, integer=False)
    x64 = t(x.astype(np.float64)) + 1e-12
    got = tc.pairwise_unexpanded_pallas(x64, t(y).double(), "l1")
    assert got.dtype == torch.float64
    want = np.abs(x64.numpy()[:, None, :] - y.astype(np.float64)[None]).sum(-1)
    np.testing.assert_allclose(n(got), want, rtol=1e-13)
    a = tc.pairwise_unexpanded_pallas(t(x), t(y), "canberra", tm=8, tn=128,
                                      kc=8)
    b = tc.pairwise_unexpanded_pallas(t(x), t(y), "canberra")
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tc.pairwise_unexpanded_pallas(t(x), t(y), "l3")
    with pytest.raises(ValueError):
        tc.pairwise_unexpanded_pallas(t(x), t(y), "l1", kc=0)


def _metric_data(name, seed=3, m=23, nn=17, k=11):
    """Inputs in each metric's domain: angles for haversine, 0/1 rows
    for the boolean metrics, positive distributions for the divergences,
    normal rows (some entries equal) otherwise."""
    rng = np.random.default_rng(seed)
    if name == "Haversine":
        return (rng.uniform(-1.5, 1.5, (m, 2)).astype(np.float32),
                rng.uniform(-1.5, 1.5, (nn, 2)).astype(np.float32))
    if name in ("JaccardExpanded", "DiceExpanded", "RusselRaoExpanded"):
        return ((rng.random((m, k)) < 0.4).astype(np.float32),
                (rng.random((nn, k)) < 0.4).astype(np.float32))
    if name in ("KLDivergence", "JensenShannon", "HellingerExpanded"):
        x = rng.random((m, k)).astype(np.float32) + 0.05
        y = rng.random((nn, k)).astype(np.float32) + 0.05
        return x / x.sum(1, keepdims=True), y / y.sum(1, keepdims=True)
    x, y = _inputs(seed, m, nn, k, integer=False)
    return x, y


def _metric_tol(name, want, k):
    """|got - want| bound: f32 sums in another order. The kernel metrics
    are their own mass; the rest are O(1) or their inputs' scale."""
    want = np.abs(np.asarray(want, np.float64))
    if name in ("CosineExpanded", "CorrelationExpanded", "InnerProduct",
                "L2Expanded", "L2SqrtExpanded"):
        return 1e-4 * (1 + want)
    return _rel(k) * want + 1e-5


@pytest.mark.parametrize("self_dist", [False, True], ids=["xy", "self"])
@pytest.mark.parametrize("name", [e.name for e in TDT])
def test_pairwise_distance_all_metrics_match_reference(name, self_dist):
    x, y = _metric_data(name)
    yy = None if self_dist else y
    with both_tiers("highest"):
        want = np.asarray(j_pd(None, x, yy, metric=JDT[name], p=3.0))
        got = n(t_pd(CPU, t(x), None if self_dist else t(y),
                     metric=TDT[name], p=3.0))
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    err = np.abs(got.astype(np.float64) - want)[fin]
    assert (err <= _metric_tol(name, want, x.shape[1])[fin]).all(), \
        err.max()
    if self_dist and name not in ("InnerProduct", "RusselRaoExpanded"):
        assert (np.diag(got) == 0).all()


@pytest.mark.parametrize("route", ["radix", "scan"])
@pytest.mark.parametrize("metric", ["l1", "manhattan", "cityblock", "linf",
                                    "chebyshev", "canberra"])
def test_knn_unexpanded_matches_reference(metric, route):
    """Integer data: l1 and linf distances are exact integers, so the
    indices must be equal (ties to the smaller index in both); canberra's
    sums of fractions may differ in the last place, so its indices may
    differ only at near-ties."""
    nn, k = {"radix": (16500, 300), "scan": (1200, 300)}[route]
    rng = np.random.default_rng(11)
    db = rng.integers(-3, 4, (nn, 8)).astype(np.float32)
    queries = rng.integers(-3, 4, (4, 8)).astype(np.float32)
    assert tbf.knn_plan(4, nn, k, metric) == jbf.knn_plan(4, nn, k, metric)
    assert tbf.knn_plan(4, nn, k, metric)[0] == route
    jv, ji = jbf.knn(None, db, queries, k, metric=metric)
    tv, ti = tbf.knn(CPU, t(db), t(queries), k, metric=metric)
    assert ti.dtype == torch.int32
    if metric != "canberra":
        np.testing.assert_array_equal(n(ti), np.asarray(ji))
        np.testing.assert_array_equal(n(tv), np.asarray(jv))
        return
    exact = n(tc.unexpanded_ref(t(queries).double(), t(db).double(),
                                "canberra"))
    got_i, want_i = n(ti), np.asarray(ji)
    for r, c in np.argwhere(got_i != want_i):
        gap = abs(exact[r, got_i[r, c]] - exact[r, want_i[r, c]])
        assert gap <= _rel(8) * exact[r, want_i[r, c]], (r, c, gap)
    np.testing.assert_allclose(n(tv), np.asarray(jv), rtol=_rel(8))
