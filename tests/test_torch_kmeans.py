"""The port's single-device k-means (raft_tpu_torch/cluster/kmeans.py)
against the reference package's.

On well-separated blobs from the same explicit initial centroids both
fits must give identical labels and ``n_iter``, and centroids within
1e-5 relative (the f32 sums differ only in accumulation order). The
k-means|| init cannot be bit-matched (JAX threefry against torch
Philox streams), so it is held to the partition: ARI = 1 on the blobs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_util import both_tiers, n, t
from raft_tpu.cluster import kmeans as jk
from raft_tpu_torch import interop
from raft_tpu_torch.cluster import kmeans as tk
from raft_tpu_torch.core.guards import ConvergenceError, ConvergenceReport


def _blobs(seed, centers=6, per=120, dim=8, spread=0.3):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-10, 10, (centers, dim))
    x = np.concatenate([rng.normal(mu[c], spread, (per, dim))
                        for c in range(centers)]).astype(np.float32)
    truth = np.repeat(np.arange(centers), per)
    perm = rng.permutation(len(x))
    init = (mu + rng.normal(0, 1.0, mu.shape)).astype(np.float32)
    return x[perm], truth[perm], init


def _inertia_tol(x, c, w=None):
    """1e-5 of the magnitudes the expanded distances cancel: for blobs far
    from the origin |x|² + |c|² dwarfs the distance itself."""
    mag = (x.astype(np.float64) ** 2).sum(1) + (c.astype(np.float64)
                                                ** 2).sum(1).max()
    return 1e-5 * float((mag if w is None else mag * w).sum())


def _ari(a, b):
    """Adjusted Rand index of two labelings."""
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1))
    np.add.at(table, (ai, bi), 1)
    comb = lambda v: (v * (v - 1) / 2).sum()  # noqa: E731
    total = comb(np.array([len(a)]))
    rows, cols = comb(table.sum(1)), comb(table.sum(0))
    expected = rows * cols / total
    return (comb(table) - expected) / (0.5 * (rows + cols) - expected)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tier", ["high", "highest"])
@pytest.mark.parametrize("check_every,sync_every", [(1, None), (3, None),
                                                    (3, 4)])
def test_kmeans_fit_matches_reference(seed, tier, check_every, sync_every):
    x, truth, init = _blobs(seed)
    p = dict(n_clusters=6, max_iter=20, tol=1e-4, init="array",
             check_every=check_every)
    with both_tiers(tier):
        jc, jinert, jlab, jiter = jk.kmeans_fit(
            None, jk.KMeansParams(**{**p, "init": jk.KMeansInit.ARRAY}), x,
            init, sync_every=sync_every)
        tc, tinert, tlab, titer = tk.kmeans_fit(
            None, interop.kmeans_params_from_dict(p), t(x), t(init),
            sync_every=sync_every)
    assert titer == jiter
    np.testing.assert_array_equal(n(tlab), n(jlab))
    np.testing.assert_allclose(n(tc), n(jc), rtol=1e-5, atol=1e-5)
    assert abs(float(tinert) - float(jinert)) <= _inertia_tol(x, n(jc))
    assert _ari(n(tlab), truth) == 1.0


@pytest.mark.parametrize("seed", [0, 3])
def test_kmeans_parallel_init_recovers_blobs(seed):
    x, truth, _ = _blobs(seed, centers=5)
    c, _, labels, _ = tk.kmeans_fit(
        None, tk.KMeansParams(n_clusters=5, seed=seed), t(x))
    assert c.shape == (5, 8)
    assert _ari(n(labels), truth) == 1.0
    # the same seed gives the same fit: no global RNG involved
    torch.manual_seed(1234)
    c2, _, labels2, _ = tk.kmeans_fit(
        None, tk.KMeansParams(n_clusters=5, seed=seed), t(x))
    assert torch.equal(c, c2) and torch.equal(labels, labels2)


def test_random_init_draws_distinct_rows():
    x, _, _ = _blobs(2, centers=3, per=20)
    p = tk.KMeansParams(n_clusters=7, init=tk.KMeansInit.RANDOM, seed=1)
    c = tk._init_centroids(p, t(x), None)
    rows = {tuple(r) for r in x.tolist()}
    assert len({tuple(r) for r in n(c).tolist()} & rows) == 7
    assert torch.equal(c, tk._init_centroids(p, t(x), None))


@pytest.mark.parametrize("tier", ["high", "highest"])
def test_lloyd_step_matches_reference(tier):
    x, _, init = _blobs(4)
    with both_tiers(tier):
        jc, jin, jl = jk.lloyd_step(x, init, 6)
        tc, tin, tl = tk.lloyd_step(t(x), t(init), 6)
    np.testing.assert_array_equal(n(tl), n(jl))
    np.testing.assert_allclose(n(tc), n(jc), rtol=1e-5, atol=1e-5)
    assert abs(float(tin) - float(jin)) <= _inertia_tol(x, init)


def test_prepared_steps_match_plain_steps():
    x, _, init = _blobs(5)
    with both_tiers("high"):
        ops, meta = tk.lloyd_prepare(t(x), 6)
        a = tk.lloyd_iterate_prepared(ops, t(init), 3, **meta)
        c = t(init)
        for _ in range(3):
            c, inertia, labels = tk.lloyd_step(t(x), c, 6)
    for u, v in zip(a, (c, inertia, labels)):
        assert torch.equal(u, v)
    with pytest.raises(ValueError):
        tk.lloyd_iterate_prepared(ops, t(init), 0, **meta)


def test_weighted_step_matches_reference():
    x, _, init = _blobs(6)
    w = np.random.default_rng(6).uniform(0.1, 2.0, len(x)).astype(np.float32)
    with both_tiers("high"):
        jc, jin, jl = jk.weighted_lloyd_step(x, w, init, 6)
        tc, tin, tl = tk.weighted_lloyd_step(t(x), t(w), t(init), 6)
    np.testing.assert_array_equal(n(tl), n(jl))
    np.testing.assert_allclose(n(tc), n(jc), rtol=1e-5, atol=1e-5)
    assert abs(float(tin) - float(jin)) <= _inertia_tol(x, init, w)


def test_weighted_fit_matches_reference():
    x, _, init = _blobs(7)
    w = np.random.default_rng(7).uniform(0.1, 2.0, len(x)).astype(np.float32)
    p = dict(n_clusters=6, max_iter=15, init="array")
    with both_tiers("high"):
        jc, jin, jl, ji = jk.kmeans_fit(
            None, jk.KMeansParams(**{**p, "init": jk.KMeansInit.ARRAY}), x,
            init, sample_weights=w)
        tc, tin, tl, ti = tk.kmeans_fit(
            None, interop.kmeans_params_from_dict(p), t(x), t(init),
            sample_weights=t(w))
    assert ti == ji
    np.testing.assert_array_equal(n(tl), n(jl))
    np.testing.assert_allclose(n(tc), n(jc), rtol=1e-5, atol=1e-5)
    assert abs(float(tin) - float(jin)) <= _inertia_tol(x, n(jc), w)
    with pytest.raises(ValueError, match="sample_weights"):
        tk.kmeans_fit(None, interop.kmeans_params_from_dict(p), t(x),
                      t(init), sample_weights=-t(w))


def test_predict_transform_cost_match_reference():
    x, _, init = _blobs(8)
    with both_tiers("high"):
        jl, jin = jk.kmeans_predict(None, x, init)
        tl, tin = tk.kmeans_predict(None, t(x), t(init))
        jt = jk.kmeans_transform(None, x, init)
        tt = tk.kmeans_transform(None, t(x), t(init))
        jcost = jk.cluster_cost(None, x, init)
        tcost = tk.cluster_cost(None, t(x), t(init))
    np.testing.assert_array_equal(n(tl), n(jl))
    assert abs(float(tin) - float(jin)) <= _inertia_tol(x, init)
    # rooted distances: the cancellation error of the squares, rooted
    assert np.abs(n(tt) - n(jt)).max() <= np.sqrt(_inertia_tol(x, init))
    assert abs(float(tcost) - float(jcost)) <= _inertia_tol(x, init)


def test_strict_and_report_match_reference():
    x, _, init = _blobs(9)
    p = dict(n_clusters=6, max_iter=1, init="array")
    with pytest.raises(ConvergenceError) as e:
        tk.kmeans_fit(None, interop.kmeans_params_from_dict(p), t(x),
                      t(init), strict=True)
    assert e.value.report.n_iter == 1 and not e.value.report.converged
    with pytest.warns(RuntimeWarning, match="not converged"):
        out = tk.kmeans_fit(None, interop.kmeans_params_from_dict(p), t(x),
                            t(init), return_report=True)
    assert isinstance(out[-1], ConvergenceReport) and len(out) == 5
    p["max_iter"] = 20
    *_, jrep = jk.kmeans_fit(
        None, jk.KMeansParams(**{**p, "init": jk.KMeansInit.ARRAY}), x, init,
        return_report=True)
    *_, trep = tk.kmeans_fit(None, interop.kmeans_params_from_dict(p), t(x),
                             t(init), return_report=True)
    assert (trep.converged, trep.n_iter) == (jrep.converged, jrep.n_iter)
    with pytest.raises(ValueError, match="sync_every"):
        tk.kmeans_fit(None, interop.kmeans_params_from_dict(p), t(x),
                      t(init), sync_every=0)


def test_params_from_reference_dict():
    jp = jk.KMeansParams(n_clusters=3, max_iter=7, init=jk.KMeansInit.RANDOM,
                         seed=5, check_every=2)
    tp = interop.kmeans_params_from_dict(dataclasses.asdict(jp))
    assert tp == tk.KMeansParams(n_clusters=3, max_iter=7,
                                 init=tk.KMeansInit.RANDOM, seed=5,
                                 check_every=2)
    assert interop.kmeans_params_from_dict({"init": "ARRAY"}).init == \
        tk.KMeansInit.ARRAY


def test_array_data_needs_the_card():
    """Non-tensor data goes to the handle's device: cuda:0 by default,
    which raises without CUDA instead of running on the CPU."""
    x, _, init = _blobs(10, centers=2, per=10)
    if torch.cuda.is_available():
        pytest.skip("CUDA present: arrays legitimately go to cuda:0")
    from raft_tpu_torch import DeviceUnavailableError, device_resources

    with pytest.raises(DeviceUnavailableError):
        tk.kmeans_predict(None, x, init)
    labels, _ = tk.kmeans_predict(device_resources("cpu"), x, init)
    assert labels.device.type == "cpu"
