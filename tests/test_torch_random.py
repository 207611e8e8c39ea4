"""The port's random generators (raft_tpu_torch.random) against the
reference package.

JAX's threefry and torch's Philox share no bits (ROADMAP.md, queue C,
"RNG streams differ"), so the contract compared is the reference's:
shape, dtype and range of every draw, and the state's
``base_subsequence`` after the same calls. Distribution moments are
checked on one fixed seed, each sample mean within 6 standard errors of
the distribution's (deterministic, not flaky: the seed is fixed).
``make_blobs`` labels are exactly round-robin; ``permute`` gives a
permutation, ``sample_without_replacement`` distinct indices, and
``multi_variable_gaussian`` a sample covariance within 6 standard errors
of the target for each decomposer.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import n, t
from raft_tpu import random as rr
from raft_tpu_torch import device_resources
from raft_tpu_torch import random as tr

RES = device_resources("cpu")
SEED = 20261018
N = 20000                      # draws for the moment checks

_DT = {jnp.float32: torch.float32, jnp.float64: torch.float64,
       jnp.int32: torch.int32, jnp.int64: torch.int64}

# name, args after (res, state), kwargs, (lo, hi) range or None,
# (mean, variance) of one draw or None
_CASES = [
    ("uniform", ((N,),), dict(low=-2.0, high=3.0), (-2.0, 3.0),
     (0.5, 25.0 / 12)),
    ("uniform_int", ((N,), -3, 7), {}, (-3, 6), (1.5, (100 - 1) / 12)),
    ("normal", ((N,),), dict(mu=1.5, sigma=2.0), None, (1.5, 4.0)),
    ("normal_int", ((N,), 10, 3), {}, None, (10.0, 9.0 + 1 / 12)),
    ("bernoulli", ((N,), 0.3), {}, None, (0.3, 0.21)),
    ("scaled_bernoulli", ((N,), 0.3, 2.0), {}, (-2.0, 2.0),
     (0.4 * 2.0, 4.0 * (1 - 0.4 ** 2))),
    ("gumbel", ((N,),), dict(mu=1.0, beta=2.0), None,
     (1.0 + 2.0 * 0.5772156649, math.pi ** 2 * 4.0 / 6)),
    ("laplace", ((N,),), dict(mu=-1.0, scale=0.5), None, (-1.0, 0.5)),
    ("logistic", ((N,),), dict(mu=2.0, scale=0.5), None,
     (2.0, 0.25 * math.pi ** 2 / 3)),
    ("lognormal", ((N,),), dict(mu=0.1, sigma=0.5), (0.0, math.inf),
     (math.exp(0.1 + 0.125),
      (math.exp(0.25) - 1) * math.exp(0.2 + 0.25))),
    ("rayleigh", ((N,),), dict(sigma=2.0), (0.0, math.inf),
     (2.0 * math.sqrt(math.pi / 2), (4 - math.pi) / 2 * 4.0)),
    ("exponential", ((N,),), dict(lam=4.0), (0.0, math.inf),
     (0.25, 1 / 16)),
]


def _port_kwargs(kw):
    return {k: (_DT[v] if k == "dtype" else v) for k, v in kw.items()}


@pytest.mark.parametrize("name,args,kw,rng,moments", _CASES,
                         ids=[c[0] for c in _CASES])
def test_generator_shape_dtype_range_and_moments(name, args, kw, rng,
                                                 moments):
    r_state, t_state = rr.RngState(SEED), tr.RngState(SEED)
    want = getattr(rr, name)(None, r_state, *args, **kw)
    got = getattr(tr, name)(RES, t_state, *args, **_port_kwargs(kw))
    assert tuple(got.shape) == tuple(want.shape)
    if want.dtype == jnp.bool_:
        assert got.dtype == torch.bool
    else:
        assert got.dtype == _DT[want.dtype.type]
    assert t_state.base_subsequence == r_state.base_subsequence == 1
    g = n(got).astype(np.float64)
    assert np.isfinite(g).all()
    if rng is not None:
        lo, hi = rng
        assert g.min() >= lo and g.max() <= hi
        if name == "uniform":
            assert g.max() < hi
    mu, var = moments
    assert abs(g.mean() - mu) <= 6 * math.sqrt(var / g.size)


def test_normal_table_columns():
    mu, sigma = [0.0, 5.0, -3.0], [1.0, 0.5, 2.0]
    r_state, t_state = rr.RngState(SEED), tr.RngState(SEED)
    want = rr.normal_table(None, r_state, N, mu, sigma)
    got = n(tr.normal_table(RES, t_state, N, mu, sigma))
    assert got.shape == want.shape and got.dtype == np.float32
    assert t_state.base_subsequence == r_state.base_subsequence
    for j in range(3):
        assert abs(got[:, j].mean() - mu[j]) <= 6 * sigma[j] / math.sqrt(N)


def test_fill_draws_nothing():
    r_state, t_state = rr.RngState(SEED), tr.RngState(SEED)
    want = rr.fill(None, r_state, (3, 4), 2.5)
    got = tr.fill(RES, t_state, (3, 4), 2.5)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert t_state.base_subsequence == r_state.base_subsequence == 0


def test_key_api_advances_as_the_reference():
    r_state, t_state = rr.RngState(SEED), tr.RngState(SEED)
    r_state.key()
    g = t_state.key("cpu")
    assert isinstance(g, torch.Generator) and g.device.type == "cpu"
    assert t_state.base_subsequence == r_state.base_subsequence == 0
    a = torch.rand(4, generator=t_state.next_key("cpu"))
    r_state.next_key()
    assert t_state.base_subsequence == r_state.base_subsequence == 1
    b = torch.rand(4, generator=t_state.key("cpu"))
    assert not torch.equal(a, b)
    keys = r_state.split(3)
    kids = t_state.split(3)
    assert len(kids) == keys.shape[0] == 3
    assert t_state.base_subsequence == r_state.base_subsequence == 2
    draws = [torch.rand(8, generator=k.next_key("cpu")) for k in kids]
    draws.append(torch.rand(8, generator=t_state.key("cpu")))
    assert len({tuple(d.tolist()) for d in draws}) == len(draws)


def _stream(state, calls=4):
    """The first draw of each of ``calls`` successive keys."""
    return tuple(tuple(torch.rand(4, generator=state.next_key("cpu"))
                       .tolist()) for _ in range(calls))


def test_split_streams_are_disjoint_when_nested():
    """Children, grandchildren and the parent's later calls and splits
    draw distinct streams: no key of one equals a key of another."""
    root = tr.RngState(SEED)
    (c0,) = root.split(1)
    c0.next_key("cpu")
    (grand,) = c0.split(1)
    (later,) = root.split(1)          # the root's second split
    siblings = root.split(3)
    states = [root, c0, grand, later] + siblings
    keys = [k for st in states for k in _stream(st)]
    assert len(set(keys)) == len(keys)


def test_split_is_deterministic():
    a, b = tr.RngState(SEED, 5), tr.RngState(SEED, 5)
    assert [_stream(s) for s in a.split(2)] == [_stream(s) for s in
                                                b.split(2)]
    assert [_stream(s) for s in a.split(2)] != [_stream(s) for s in
                                                tr.RngState(SEED, 5).split(2)]


def test_key_defaults_to_the_handle_device(monkeypatch):
    """With no device named, a key lands on the process-wide handle's
    device, which is the card (so it raises here, with no CUDA)."""
    from raft_tpu_torch.core import resources
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(resources.DeviceUnavailableError):
        tr.RngState(SEED).key()


def test_call_sequence_keeps_base_subsequence():
    """A run of the calls no other test counts, mixed with a draw: the
    two states advance alike (``fill`` not at all)."""
    r_state, t_state = rr.RngState(7), tr.RngState(7)
    calls = [
        lambda p, s, m: p.uniform(m, s, 5),
        lambda p, s, m: p.fill(m, s, 3, 1.0),
        lambda p, s, m: p.sample(m, s, 2, [1.0, 2.0, 3.0], replace=False),
        lambda p, s, m: p.discrete(m, s, 2, [1.0, 1.0]),
        lambda p, s, m: p.rmat_rectangular_gen(m, s, 3, 3, 10),
        lambda p, s, m: p.uniform(m, s, 5),
    ]
    for call in calls:
        call(rr, r_state, None)
        call(tr, t_state, RES)
        assert t_state.base_subsequence == r_state.base_subsequence
    assert t_state.base_subsequence == 5


def test_sample_with_replacement_follows_the_weights():
    w = np.array([0.0, 1.0, 0.0, 3.0, 4.0, 0.0], np.float32)
    r_state, t_state = rr.RngState(SEED), tr.RngState(SEED)
    want = rr.sample(None, r_state, N, w)
    got = n(tr.sample(RES, t_state, N, t(w)))
    assert got.shape == want.shape and got.dtype == np.int32
    assert t_state.base_subsequence == r_state.base_subsequence == 1
    assert set(np.unique(got)) <= {1, 3, 4}
    p = w / w.sum()
    freq = np.bincount(got, minlength=w.size) / N
    assert (np.abs(freq - p) <= 6 * np.sqrt(p * (1 - p) / N)).all()


def test_sample_draws_past_two_to_the_24_categories():
    """No multinomial cap: the one weighted category past 2^24 is the
    only one drawn."""
    w = torch.zeros((1 << 24) + 7, dtype=torch.float32)
    w[(1 << 24) + 5] = 1.0
    got = tr.sample(RES, tr.RngState(SEED), 16, w)
    assert (got == (1 << 24) + 5).all()


@pytest.mark.parametrize("weighted", [False, True])
def test_sample_without_replacement_distinct(weighted):
    pool, k = 300, 120
    w = np.random.default_rng(SEED).uniform(0.1, 2.0, pool).astype(
        np.float32) if weighted else None
    r_state, t_state = rr.RngState(SEED), tr.RngState(SEED)
    want = rr.sample_without_replacement(
        None, r_state, k, weights=w, pool_size=None if weighted else pool)
    got = n(tr.sample_without_replacement(
        RES, t_state, k, weights=None if w is None else t(w),
        pool_size=None if weighted else pool))
    assert got.shape == want.shape and got.dtype == np.int32
    assert t_state.base_subsequence == r_state.base_subsequence == 1
    assert np.unique(got).size == k
    assert got.min() >= 0 and got.max() < pool
    with pytest.raises(ValueError):
        tr.sample_without_replacement(RES, t_state, pool + 1,
                                      pool_size=pool)
    with pytest.raises(ValueError):
        tr.sample_without_replacement(RES, t_state, 3)


def test_sample_without_replacement_skips_zero_weights():
    w = np.zeros(50, np.float32)
    w[[3, 17, 29, 41]] = 1.0
    got = n(tr.sample_without_replacement(RES, tr.RngState(SEED), 4,
                                          weights=t(w)))
    assert sorted(got.tolist()) == [3, 17, 29, 41]


def test_excess_subsample_uniform_over_the_pool():
    """Each of 40 slots is drawn 10 times in 400 draws of 10 (a draw of
    10 from 40), within 6 binomial standard errors."""
    state = tr.RngState(SEED)
    hits = np.zeros(40)
    for _ in range(400):
        idx = n(tr.excess_subsample(RES, state, 10, 40))
        assert np.unique(idx).size == 10
        hits[idx] += 1
    p = 10 / 40
    assert (np.abs(hits - 400 * p) <= 6 * math.sqrt(400 * p * (1 - p))).all()


def test_permute_and_permute_rows():
    r_state, t_state = rr.RngState(SEED), tr.RngState(SEED)
    want = rr.permute(None, r_state, 97)
    got = n(tr.permute(RES, t_state, 97))
    assert got.dtype == np.int32 and got.shape == want.shape
    assert sorted(got.tolist()) == list(range(97))
    x = np.random.default_rng(SEED).normal(size=(33, 5)).astype(np.float32)
    rx, rperm = rr.permute_rows(None, r_state, x)
    px, perm = tr.permute_rows(RES, t_state, t(x))
    assert perm.dtype == torch.int32 and sorted(perm.tolist()) == \
        list(range(33))
    np.testing.assert_array_equal(n(px), x[n(perm)])
    assert tuple(px.shape) == rx.shape
    assert t_state.base_subsequence == r_state.base_subsequence == 2


def test_make_blobs_round_robin_and_spread(n_rows=997, n_clusters=10):
    r_state, t_state = rr.RngState(SEED), tr.RngState(SEED)
    rx, rl_, rc = rr.make_blobs(None, r_state, n_rows, 6,
                                n_clusters=n_clusters, cluster_std=0.5,
                                center_box=(-4.0, 4.0))
    x, lab, c = tr.make_blobs(RES, t_state, n_rows, 6,
                              n_clusters=n_clusters, cluster_std=0.5,
                              center_box=(-4.0, 4.0))
    assert tuple(x.shape) == rx.shape and tuple(c.shape) == rc.shape
    assert x.dtype == torch.float32 and lab.dtype == torch.int32
    assert t_state.base_subsequence == r_state.base_subsequence == 1
    want_counts = np.bincount(np.arange(n_rows) % n_clusters,
                              minlength=n_clusters)
    np.testing.assert_array_equal(np.bincount(n(lab), minlength=n_clusters),
                                  want_counts)
    np.testing.assert_array_equal(
        np.bincount(np.asarray(rl_), minlength=n_clusters), want_counts)
    c = n(c)
    assert c.min() >= -4.0 and c.max() < 4.0
    noise = n(x) - c[n(lab)]
    assert abs(noise.mean()) <= 6 * 0.5 / math.sqrt(noise.size)
    # an unshuffled call keeps the round-robin order itself
    _, lab2, _ = tr.make_blobs(RES, t_state, 20, 2, n_clusters=3,
                               shuffle=False)
    np.testing.assert_array_equal(n(lab2), np.arange(20) % 3)


def test_make_blobs_honours_given_centers():
    centers = np.array([[0.0, 0.0], [10.0, 10.0], [-10.0, 5.0]], np.float32)
    x, lab, c = tr.make_blobs(RES, tr.RngState(SEED), 300, 2, n_clusters=9,
                              cluster_std=0.01, centers=t(centers))
    np.testing.assert_array_equal(n(c), centers)
    assert set(n(lab).tolist()) == {0, 1, 2}
    assert np.abs(n(x) - centers[n(lab)]).max() < 0.1
    rx, rlab, rc = rr.make_blobs(None, rr.RngState(SEED), 300, 2,
                                 n_clusters=9, centers=centers)
    assert rc.shape == tuple(c.shape)


@pytest.mark.parametrize("effective_rank", [None, 3])
def test_make_regression_shapes_and_fit(effective_rank):
    r_state, t_state = rr.RngState(SEED), tr.RngState(SEED)
    kw = dict(n_informative=3, n_targets=2, bias=1.5,
              effective_rank=effective_rank)
    rx, ry, rw = rr.make_regression(None, r_state, 200, 8, **kw)
    x, y, w = tr.make_regression(RES, t_state, 200, 8, **kw)
    assert (tuple(x.shape), tuple(y.shape), tuple(w.shape)) == \
        (rx.shape, ry.shape, rw.shape)
    assert x.dtype == y.dtype == w.dtype == torch.float32
    assert t_state.base_subsequence == r_state.base_subsequence == 1
    w = n(w).astype(np.float64)
    assert (np.count_nonzero(w.any(1))) == 3
    assert w.min() >= 0 and w.max() < 100
    resid = n(y) - (n(x).astype(np.float64) @ w + 1.5)
    assert np.abs(resid).max() <= 1e-4 * (np.abs(n(x)) @ np.abs(w)).max() \
        + 1e-4


@pytest.mark.parametrize("method", ["CHOLESKY", "JACOBI", "QR"])
def test_multi_variable_gaussian_covariance(method):
    cov = np.array([[2.0, 0.6, -0.3], [0.6, 1.0, 0.2], [-0.3, 0.2, 0.5]])
    mean = np.array([1.0, -2.0, 0.5])
    r_state, t_state = rr.RngState(SEED), tr.RngState(SEED)
    want = rr.multi_variable_gaussian(None, r_state, mean, cov, N,
                                      method=rr.Decomposer[method])
    got = n(tr.multi_variable_gaussian(RES, t_state, t(mean), t(cov), N,
                                       method=tr.Decomposer[method]))
    assert got.shape == want.shape and got.dtype == np.float32
    assert t_state.base_subsequence == r_state.base_subsequence == 1
    assert tr.Decomposer[method].value == rr.Decomposer[method].value
    g = got.astype(np.float64)
    se_mean = np.sqrt(np.diag(cov) / N)
    assert (np.abs(g.mean(0) - mean) <= 6 * se_mean).all()
    s = np.cov(g.T)
    se = np.sqrt((np.outer(np.diag(cov), np.diag(cov)) + cov ** 2) / N)
    assert (np.abs(s - cov) <= 6 * se).all()
