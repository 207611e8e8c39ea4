"""The port's radix select (raft_tpu_torch/matrix/radix_select.py) against
the reference package's on the same numpy inputs. On the CPU the port
runs the plain versions of its two kernels; the reference runs its
Pallas kernels in interpret mode. Selection is exact, so indices and
values must be equal, bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from _torch_util import n, t
from raft_tpu.matrix import radix_select as jrs
from raft_tpu_torch.matrix import radix_select as trs

DTYPES = ("float32", "bfloat16", "float16", "int8", "int16", "int32",
          "uint8", "uint16", "uint32")


def _values(dtype: str, shape, seed: int) -> np.ndarray:
    """Seeded values of ``dtype`` with duplicates, as a numpy array the
    reference takes (bfloat16 through jnp)."""
    rng = np.random.default_rng(seed)
    if dtype in ("float32", "bfloat16", "float16"):
        v = rng.normal(size=shape).astype(np.float32)
        v[:, ::7] = v[:, :1]                  # ties with column 0
        return v.astype(jnp.dtype(dtype))
    info = np.iinfo(dtype)
    lo, hi = max(info.min, -1000), min(info.max, 1000)
    v = rng.integers(lo, hi, size=shape, endpoint=True).astype(dtype)
    v[0, :5] = info.min
    v[-1, -5:] = info.max
    return v


def _torch(v: np.ndarray) -> torch.Tensor:
    if v.dtype == jnp.bfloat16:
        return t(v.astype(np.float32)).to(torch.bfloat16)
    return t(v)


def _equal(got, want):
    np.testing.assert_array_equal(
        n(got.to(torch.float64) if got.dtype == torch.bfloat16 else got
          ).astype(np.float64), np.asarray(want).astype(np.float64))


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_radix_select_k_matches_reference(dtype, select_min):
    v = _values(dtype, (5, 3000), seed=DTYPES.index(dtype))
    jv, ji = jrs.radix_select_k(jnp.asarray(v), 40, select_min)
    tv, ti = trs.radix_select_k(_torch(v), 40, select_min)
    np.testing.assert_array_equal(n(ti), np.asarray(ji))
    _equal(tv, jv)
    assert tv.dtype == _torch(v).dtype


@pytest.mark.parametrize("case", ["random", "k1", "k_len", "all_equal",
                                  "straddle", "nan_inf"])
def test_radix_ranks_match_reference(case):
    """The two kernels' function (threshold + emission, in column order)
    on int32 keys, as the reference's ``_radix_ranks`` computes it."""
    rng = np.random.default_rng(3)
    v = rng.normal(size=(4, 1500)).astype(np.float32)
    k = 33
    if case == "k1":
        k = 1
    elif case == "k_len":
        k = v.shape[1]
    elif case == "all_equal":
        v[:] = 2.5
    elif case == "straddle":                  # a tie run across the k-th
        v[:, 100:140] = -50.0
        v[:, :20] = -60.0
    elif case == "nan_inf":
        v[0, ::3] = np.nan
        v[1, ::2] = np.inf
        v[2, ::5] = -np.inf
        v[3, 10:20] = -np.nan
    keys = trs._to_key(t(v), True)
    want = np.asarray(jrs._radix_ranks(jnp.asarray(n(keys)), k))
    got = trs._radix_ranks(keys, k)
    np.testing.assert_array_equal(n(got), want)
    tt, ntie = trs._threshold_plain(keys, k)
    assert (n(ntie) >= 1).all()
    assert (n(ntie) + (n(keys) < n(tt)[:, None]).sum(1) == k).all()


def test_two_level_past_chunk_bound(monkeypatch):
    """Rows past CHUNK_LEN take the two-level path in both packages;
    CHUNK_LEN is patched small in both, cross-chunk ties included."""
    monkeypatch.setattr(jrs, "CHUNK_LEN", 4096)
    monkeypatch.setattr(trs, "CHUNK_LEN", 4096)
    rng = np.random.default_rng(31)
    v = rng.normal(size=(3, 10000)).astype(np.float32)
    v[0, 17] = v[0, 4500] = v[0, 9999] = v[0].min() - 1.0
    v[1, 5000:5008] = -100.0
    v2 = np.full((2, 9001), 7.0, np.float32)
    for vv, k in ((v, 12), (v2, 20)):
        for select_min in (True, False):
            jv, ji = jrs.radix_select_k(jnp.asarray(vv), k, select_min)
            tv, ti = trs.radix_select_k(t(vv), k, select_min)
            np.testing.assert_array_equal(n(ti), np.asarray(ji))
            np.testing.assert_array_equal(n(tv), np.asarray(jv))


def test_supports_and_preferred_match_reference():
    for dtype in DTYPES + ("float64", "int64"):
        for cols, k in ((1000, 10), (1000, 2000), (1 << 20, 300),
                        ((1 << 20) + 1, 16), (1 << 24, 256),
                        ((1 << 24) + 1, 16), (32768, 16385)):
            want = jrs.supports(jnp.dtype(dtype), cols, k)
            got = trs.supports(getattr(torch, dtype), cols, k)
            assert got == want, (dtype, cols, k)
    for cols in (100, 8191, 8192, 65536, (1 << 20) - 1, 1 << 20, 1 << 24,
                 (1 << 24) + 1):
        for k in (1, 16, 17, 256, 257, 2048, 16384, 16385):
            assert trs.preferred(cols, k) == jrs.preferred(cols, k)


def test_rejects_unsupported_problems():
    with pytest.raises(ValueError):
        trs.radix_select_k(torch.zeros(2, 100), 200)
    with pytest.raises(ValueError):
        trs.radix_select_k(torch.zeros(2, 100, dtype=torch.float64), 5)
