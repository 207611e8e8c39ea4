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

# an H100's opt-in shared memory a block, bytes
H100_SMEM_OPTIN = 232448
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


@pytest.mark.parametrize("shape,form", [
    ("knn_chunk", "row"), ("knn_l1_chunk", "row"), ("select", "stream"),
    ("knn_256_queries", "stream"), ("merge_pool", "row"),
    ("under_limit", "row"), ("at_limit", "row"), ("over_limit", "stream"),
    ("one_key", "row"), ("many_short_rows", "row")])
def test_threshold_plan_picks_the_form_from_the_shapes(shape, form):
    """radix_threshold's plan: the row-resident form wherever a row fits
    in a block's shared memory (both kNN radix routes' 4096 x 32,768
    chunks, the two-level merge pool, rows up to _row_keys_max keys), the
    streaming form past it (the select shape 64 x 2^20, the 256-query
    linf/canberra chunks of 524,288 keys)."""
    from raft_tpu_torch.neighbors import knn_plan

    limit = trs._row_keys_max(H100_SMEM_OPTIN)
    rows, n_cols = {
        "knn_chunk": (4096, knn_plan(4096, 1 << 20, 1024)[1]),
        "knn_l1_chunk": (4096, knn_plan(4096, 1 << 20, 64, "l1")[1]),
        "select": (64, 1 << 20),
        "knn_256_queries": (256, knn_plan(256, 1 << 20, 64, "linf")[1]),
        "merge_pool": (64, 2 * 2048),
        "under_limit": (3, limit - 1), "at_limit": (3, limit),
        "over_limit": (3, limit + 1), "one_key": (1, 1),
        "many_short_rows": (100000, 100)}[shape]
    if shape.startswith("knn"):
        assert n_cols == (32768 if shape != "knn_256_queries" else 524288)
    plan = trs._threshold_plan(rows, n_cols, H100_SMEM_OPTIN)
    assert plan.form == form
    if form == "row":
        assert (plan.splits, plan.cand_cap, plan.scratch_bytes) == (1, 0, 0)
        assert plan.smem_bytes == trs.ROW_FIXED_BYTES + 4 * (
            (n_cols + 3 + 3) // 4 * 4) <= H100_SMEM_OPTIN
        return
    assert plan.smem_bytes == 0 and plan.span % 1024 == 0
    assert (plan.splits - 1) * plan.span < n_cols <= plan.splits * plan.span
    assert rows * plan.splits >= min(trs.TARGET_BLOCKS,
                                     rows * (n_cols // 4096))
    assert plan.cand_cap % 4 == 0
    assert min(n_cols, trs.MIN_CANDIDATES) <= plan.cand_cap <= n_cols + 3
    assert plan.scratch_bytes == 4 * rows * (
        trs.THRESHOLD_PASSES * trs.THRESHOLD_BINS + 1 + plan.cand_cap)


def test_threshold_plan_row_limit_is_the_shared_memory_limit():
    """_row_keys_max is the longest row whose shared memory (histogram,
    scratch, the candidate buffer, the row with up to 3 keys of
    misalignment in 16-byte groups) fits a block's opt-in limit; one key
    more does not. On an H100 that is 53,949 keys, above the kNN radix
    routes' 32,768-key chunks."""
    def smem(n):
        return trs.ROW_FIXED_BYTES + 4 * ((n + 3 + 3) // 4 * 4)

    limit = trs._row_keys_max(H100_SMEM_OPTIN)
    assert limit == 53949
    assert smem(limit) <= H100_SMEM_OPTIN < smem(limit + 1)
    with pytest.raises(ValueError):
        trs._threshold_plan(0, 10, H100_SMEM_OPTIN)


def _cu_constants(path):
    """The namespace-scope ``constexpr int`` constants of a CUDA source,
    evaluated in order (each may use the earlier ones)."""
    import re
    from pathlib import Path

    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                 Path(path).read_text(), re.M):
        env[name] = eval(expr.replace(" / ", " // "), {}, dict(env))
    return env


@pytest.mark.parametrize("name,kernel_name", [
    ("THRESHOLD_BINS", "kBins"), ("THRESHOLD_PASSES", "kStreamPasses"),
    ("ROW_FIXED_BYTES", "kRowFixedBytes")])
def test_threshold_layout_matches_the_kernel_source(name, kernel_name):
    """The plan's copy of csrc/radix_threshold.cu's layout (histogram
    bins, streaming passes, the row form's fixed shared memory) equals the
    kernel's own constants, read from its source."""
    from pathlib import Path

    src = Path(trs.__file__).parent.parent / "csrc" / "radix_threshold.cu"
    assert getattr(trs, name) == _cu_constants(src)[kernel_name]


@pytest.mark.parametrize("case", ["random", "k1", "k_len", "all_equal",
                                  "straddle"])
def test_threshold_cpu_route_is_the_plain_version(case):
    """On CPU keys the wrapper returns the plain threshold, whatever the
    plan would pick on the card; a view with ld > len is taken as is."""
    rng = np.random.default_rng(7)
    wide = rng.normal(size=(3, 2100)).astype(np.float32)
    k = {"k1": 1, "k_len": 2000}.get(case, 50)
    if case == "all_equal":
        wide[:] = -1.5
    elif case == "straddle":
        wide[:, 30:90] = -40.0
    keys = trs._to_key(t(wide), True)[:, 100:2100]
    assert keys.stride(0) == 2100
    got = trs._radix_threshold(keys, k)
    want = trs._threshold_plain(keys.contiguous(), k)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # T is the k-th smallest key; n_tie of its copies complete the k
    srt = np.sort(n(keys), axis=1)
    np.testing.assert_array_equal(n(got[0]), srt[:, k - 1])
    below = (n(keys) < n(got[0])[:, None]).sum(1)
    np.testing.assert_array_equal(n(got[1]), k - below)
