"""The port's select_k, its insertion select and the lax.top_k order
helper (raft_tpu_torch/matrix) against the reference package's on the
same numpy inputs. On the CPU the port runs the plain versions of its
kernels; the reference runs its Pallas kernels in interpret mode.
Selection is exact, so indices and values must be equal, bit for bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_util import n, t
from raft_tpu.matrix import SelectAlgo as JAlgo
from raft_tpu.matrix import select_k as j_select_k
from raft_tpu.matrix import topk_insert as jti
from raft_tpu_torch.matrix import SelectAlgo as TAlgo
from raft_tpu_torch.matrix import _topk_order
from raft_tpu_torch.matrix import select_k as t_select_k
from raft_tpu_torch.matrix import topk_insert as tti
from raft_tpu_torch.matrix.epilogue import argmax, argmin

SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.0, 1.0,
                    -1.0, 0.0, -0.0, np.nan], np.float32)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("largest", [True, False])
def test_topk_order_matches_lax_top_k(largest):
    """IEEE total order (+0 above -0, +NaN above +inf, -NaN below -inf),
    the smaller index first among equal values; values bit-exact."""
    x = np.stack([SPECIAL, SPECIAL[::-1]])
    k = x.shape[1]
    jv, ji = jax.lax.top_k(jnp.asarray(x if largest else -x), k)
    jv = np.asarray(jv) if largest else -np.asarray(jv)
    tv, ti = _topk_order.topk(t(x), k, largest=largest)
    np.testing.assert_array_equal(n(ti), np.asarray(ji))
    np.testing.assert_array_equal(_bits(n(tv)), _bits(jv))


def _floats(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=shape).astype(np.float32)
    v[:, ::9] = v[:, 3:4]                     # ties
    return v.astype(jnp.dtype(dtype))


def _torch(v):
    if v.dtype == jnp.bfloat16:
        return t(v.astype(np.float32)).to(torch.bfloat16)
    return t(v)


def _equal(got, want):
    assert np.array_equal(n(got.to(torch.float64)),
                          np.asarray(want).astype(np.float64),
                          equal_nan=True)


@pytest.mark.parametrize("case", ["random", "sorted_desc", "nan_row",
                                  "few_finite"])
@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_insert_select_matches_reference(dtype, select_min, case):
    """insert_select, including the degenerate re-answer through the
    direct select (a row with fewer than k candidates)."""
    v = _floats(dtype, (9, 700), seed=5)
    if case == "sorted_desc":
        v = -np.sort(-v.astype(np.float32), axis=1).astype(v.dtype)
    elif case == "nan_row":
        v[2, :] = np.nan
    elif case == "few_finite":
        v[4, 5:] = np.inf if select_min else -np.inf
    jv, ji = jti.insert_select(jnp.asarray(v), 24, select_min)
    tv, ti = tti.insert_select(_torch(v), 24, select_min)
    np.testing.assert_array_equal(n(ti), np.asarray(ji))
    _equal(tv, jv)
    assert tv.dtype == _torch(v).dtype and ti.dtype == torch.int32


def test_insert_select_validates_the_tile_knobs():
    v = torch.zeros(3, 600)
    with pytest.raises(ValueError):
        tti.insert_select(v, 4, sw=384)       # not a divisor of tn=2048
    with pytest.raises(ValueError):
        tti.insert_select(v.to(torch.int32), 4)


# (shape, k, dtype) reaching each route: radix (in the band), insert,
# direct, stream (ints, or k above the radix and insert bands) and tiled
# (the radix enums above MAX_K; AUTO on a 2^20 row with k <= 256, which
# runs for AUTO alone to keep the reference's interpreted kernels short)
CASES = {
    "short": ((4, 300), 7, "float32"),
    "radix_band": ((3, 9000), 40, "float32"),
    "ints": ((3, 20000), 11, "int32"),
    "half": ((3, 2000), 30, "float16"),
    "k_above_bands": ((2, 20000), 16385, "float32"),
    "wide_row": ((1, 1 << 20), 32, "float32"),
}
ROUTES = [(c, a.name) for c in sorted(CASES) for a in JAlgo
          if c != "wide_row" or a is JAlgo.AUTO]


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("case,algo", ROUTES)
def test_select_k_matches_reference(case, algo, select_min):
    shape, k, dtype = CASES[case]
    rng = np.random.default_rng(len(case))
    if dtype == "int32":
        v = rng.integers(-50, 50, size=shape).astype(np.int32)
    else:
        v = _floats(dtype, shape, seed=len(case))
    jv, ji = j_select_k(None, jnp.asarray(v), k, select_min,
                        algo=JAlgo[algo])
    tv, ti = t_select_k(None, _torch(v), k, select_min, algo=TAlgo[algo])
    np.testing.assert_array_equal(n(ti), np.asarray(ji))
    _equal(tv, jv)
    assert ti.dtype == torch.int32


def test_select_k_in_idx_and_squeeze():
    rng = np.random.default_rng(8)
    v = rng.normal(size=(3, 500)).astype(np.float32)
    payload = rng.permutation(3 * 500).reshape(3, 500).astype(np.int32)
    jv, ji = j_select_k(None, v, 9, False, in_idx=payload)
    tv, ti = t_select_k(None, t(v), 9, False, in_idx=t(payload))
    np.testing.assert_array_equal(n(ti), np.asarray(ji))
    np.testing.assert_array_equal(n(tv), np.asarray(jv))
    jv, ji = j_select_k(None, v[1], 5)
    tv, ti = t_select_k(None, t(v[1]), 5)
    assert tuple(ti.shape) == (5,)
    np.testing.assert_array_equal(n(ti), np.asarray(ji))
    np.testing.assert_array_equal(n(tv), np.asarray(jv))
    with pytest.raises(ValueError):
        t_select_k(None, t(v), 501)


def test_select_algo_menu_matches_reference():
    assert [(a.name, a.value) for a in TAlgo] == \
        [(a.name, a.value) for a in JAlgo]


def test_argmin_argmax_match_reference():
    from raft_tpu.matrix import epilogue as je

    x = np.stack([SPECIAL, SPECIAL[::-1], np.arange(12, dtype=np.float32)])
    x[2, 7] = x[2, 3] = 11.0
    for fn, jfn in ((argmin, je.argmin), (argmax, je.argmax)):
        np.testing.assert_array_equal(n(fn(None, t(x))),
                                      np.asarray(jfn(None, x)))
        xi = (x[2:] * 3).astype(np.int32)
        np.testing.assert_array_equal(n(fn(None, t(xi))),
                                      np.asarray(jfn(None, xi)))
