"""The port's R-MAT generator (raft_tpu_torch.random.rmat) against the
reference's contract: shape, dtype and range, and the distribution. The
two packages draw from different generators (JAX threefry, torch
Philox), so the bits differ and the check is statistical: each level's
quadrant frequencies lie within 5 binomial standard deviations (+1) of
the (a, b, c, d) table, and the top-level quadrant histograms of the two
packages on the same edge count agree within the same bound.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.random import RngState as JRng
from raft_tpu.random.rmat import rmat_rectangular_gen as jrmat
from raft_tpu_torch import device_resources
from raft_tpu_torch.random import RngState, rmat_rectangular_gen

N_EDGES = 20000


def _cpu():
    return device_resources("cpu")


def _within_binomial(count, total, p):
    sd = np.sqrt(total * p * (1 - p))
    return abs(count - total * p) <= 5 * sd + 1


def _level_quadrants(src, dst, r_scale, c_scale, lvl):
    """Quadrant (2·row bit + column bit) drawn at level ``lvl``; -1 where a
    dimension's scale is exhausted."""
    rb = (src >> (r_scale - 1 - lvl)) & 1 if lvl < r_scale else None
    cb = (dst >> (c_scale - 1 - lvl)) & 1 if lvl < c_scale else None
    return rb, cb


@pytest.mark.parametrize("r_scale,c_scale", [(10, 10), (12, 7), (6, 11)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_rmat_shape_dtype_range_and_levels(r_scale, c_scale, dtype):
    a, b, c = 0.57, 0.19, 0.19
    src, dst = rmat_rectangular_gen(_cpu(), RngState(5), r_scale, c_scale,
                                    N_EDGES, a=a, b=b, c=c, dtype=dtype)
    assert src.shape == dst.shape == (N_EDGES,)
    assert src.dtype == dst.dtype == dtype and src.device.type == "cpu"
    s, d = src.numpy(), dst.numpy()
    assert s.min() >= 0 and s.max() < 2 ** r_scale
    assert d.min() >= 0 and d.max() < 2 ** c_scale
    probs = np.array([a, b, c, 1 - a - b - c])
    for lvl in range(max(r_scale, c_scale)):
        rb, cb = _level_quadrants(s, d, r_scale, c_scale, lvl)
        if rb is not None and cb is not None:
            q = 2 * rb + cb
            for quad in range(4):
                assert _within_binomial(int((q == quad).sum()), N_EDGES,
                                        probs[quad]), (lvl, quad)
        elif rb is not None:            # column scale exhausted
            assert _within_binomial(int(rb.sum()), N_EDGES, c + probs[3])
        else:
            assert _within_binomial(int(cb.sum()), N_EDGES, b + probs[3])


def test_rmat_theta_table():
    rng = np.random.default_rng(0)
    theta = rng.dirichlet(np.ones(4), size=8).astype(np.float32)
    src, dst = rmat_rectangular_gen(_cpu(), RngState(9), 8, 8, N_EDGES,
                                    theta=torch.from_numpy(theta))
    js, jd = jrmat(None, JRng(9), 8, 8, N_EDGES, theta=jnp.asarray(theta))
    for lvl in range(8):
        for s, d in ((src.numpy(), dst.numpy()),
                     (np.asarray(js), np.asarray(jd))):
            rb, cb = _level_quadrants(s, d, 8, 8, lvl)
            q = 2 * rb + cb
            for quad in range(4):
                assert _within_binomial(int((q == quad).sum()), N_EDGES,
                                        float(theta[lvl, quad]))


def test_rmat_top_level_histogram_matches_reference():
    src, dst = rmat_rectangular_gen(_cpu(), RngState(1), 14, 14, N_EDGES)
    js, jd = jrmat(None, JRng(1), 14, 14, N_EDGES)
    got = np.bincount(2 * (src.numpy() >> 13) + (dst.numpy() >> 13),
                      minlength=4)
    want = np.bincount(2 * (np.asarray(js) >> 13) + (np.asarray(jd) >> 13),
                       minlength=4)
    assert np.asarray(js).dtype == src.numpy().dtype == np.int32
    probs = np.array([0.57, 0.19, 0.19, 0.05])
    sd = np.sqrt(2 * N_EDGES * probs * (1 - probs))
    assert np.all(np.abs(got - want) <= 5 * sd + 1), (got, want)


def test_rmat_state_advances_and_scale_limit():
    state = RngState(3)
    a = rmat_rectangular_gen(_cpu(), state, 8, 8, 100)
    b = rmat_rectangular_gen(_cpu(), state, 8, 8, 100)
    again = rmat_rectangular_gen(_cpu(), RngState(3), 8, 8, 100)
    assert torch.equal(a[0], again[0]) and torch.equal(a[1], again[1])
    assert not torch.equal(a[0], b[0])
    with pytest.raises(ValueError, match="int64"):
        rmat_rectangular_gen(_cpu(), RngState(0), 32, 4, 10)
    src, _ = rmat_rectangular_gen(_cpu(), RngState(0), 33, 4, 10,
                                  dtype=torch.int64)
    assert src.dtype == torch.int64
