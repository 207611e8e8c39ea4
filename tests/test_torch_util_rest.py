"""The port's util layer against the reference package: input checks,
integer math, itertools, the architecture query, the precision ladder
and the vector caches, on the same numpy inputs made from a seed.

Exact throughout: error types and messages, integer results, cache hits,
returned vectors and every tensor of the cache state. The reference
modules are imported in a fixture, so the card tests at the end run
where JAX is absent (``-m cuda --noconftest``).
"""

import types

import numpy as np
import pytest
import torch

from raft_tpu_torch import interop
from raft_tpu_torch.core import resources as tres
from raft_tpu_torch.util import arch as tarch
from raft_tpu_torch.util import cache as tcache
from raft_tpu_torch.util import input_validation as tiv
from raft_tpu_torch.util import itertools as tit
from raft_tpu_torch.util import math as tmath
from raft_tpu_torch.util import numerics as tnum
from raft_tpu_torch.util import precision as tprec

SEED = 16


@pytest.fixture(scope="module")
def ref():
    from raft_tpu.util import arch, cache, input_validation, itertools, \
        math, numerics

    return types.SimpleNamespace(arch=arch, cache=cache,
                                 iv=input_validation, it=itertools,
                                 math=math, num=numerics)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _raised(fn):
    try:
        fn()
    except Exception as e:      # the type and message are compared
        return type(e).__name__, str(e)
    return None


# -- input validation -----------------------------------------------------------

def _validation_cases(a, b, sq):
    return [
        ("expect", (True, "fine")), ("expect", (False, "bad input")),
        ("expect_shape", (a, (4, 3))), ("expect_shape", (a, (4, None))),
        ("expect_shape", (a, (3, 4), "x")), ("expect_shape", (a, (4,))),
        ("expect_same_shape", (a, a)), ("expect_same_shape", (a, b)),
        ("expect_same_shape", (a, b, ("x", "y"))),
        ("expect_square", (sq,)), ("expect_square", (a, "m")),
        ("expect_square", (a[0],)),
        ("expect_2d", (a,)), ("expect_2d", (a[0], "v")),
    ]


def test_expecters_match(ref):
    rng = np.random.default_rng(SEED)
    na, nb, nsq = (rng.random(s, dtype=np.float32)
                   for s in ((4, 3), (3, 4), (3, 3)))
    ta, tb, tsq = map(torch.from_numpy, (na, nb, nsq))
    for (name, rargs), (_, targs) in zip(_validation_cases(na, nb, nsq),
                                         _validation_cases(ta, tb, tsq)):
        want = _raised(lambda: getattr(ref.iv, name)(*rargs))
        got = _raised(lambda: getattr(tiv, name)(*targs))
        assert got == want, name


@pytest.mark.parametrize("dtypes,tdtypes", [
    (np.float32, torch.float32),
    ([np.float32, np.float64], [torch.float32, torch.float64]),
    ((np.int32, np.int64), (torch.int32, torch.int64)),
    ([np.bool_, np.uint8], [torch.bool, torch.uint8]),
])
def test_expect_dtype_matches(ref, dtypes, tdtypes):
    for npdt in (np.float32, np.float64, np.int32, np.bool_, np.float16):
        a = np.zeros(3, npdt)
        want = _raised(lambda: ref.iv.expect_dtype(a, dtypes, "w"))
        assert _raised(lambda: tiv.expect_dtype(
            torch.from_numpy(a), tdtypes, "w")) == want
        # numpy spellings and numpy arrays are taken too
        assert _raised(lambda: tiv.expect_dtype(a, dtypes, "w")) == want


# -- integer math ---------------------------------------------------------------

def test_integer_math_matches(ref):
    xs = list(range(0, 70)) + [127, 128, 129, 1000, 4095, 4096, 65537]
    for x in xs:
        for m in (1, 3, 8, 128):
            assert tmath.round_down_to_multiple(x, m) == \
                ref.math.round_down_to_multiple(x, m)
            assert tmath.round_up_to_multiple(x, m) == \
                ref.math.round_up_to_multiple(x, m)
        assert tmath.is_pow2(x) == ref.math.is_pow2(x)
        assert tmath.next_pow2(x) == ref.math.next_pow2(x)
        assert _raised(lambda: tmath.prev_pow2(x)) == \
            _raised(lambda: ref.math.prev_pow2(x))
        if x >= 1:
            assert tmath.prev_pow2(x) == ref.math.prev_pow2(x)
        for cap in (1, 64, 1024):
            for ratio in (1, 4, 7):
                assert tmath.bound_by_power_of_two_and_ratio(x, cap, ratio) \
                    == ref.math.bound_by_power_of_two_and_ratio(x, cap, ratio)


def test_pow2_fastintdiv_seive_match(ref):
    for v in (1, 2, 64, 1024):
        p, rp = tmath.Pow2(v), ref.math.Pow2(v)
        assert (p.value, p.mask, p.log2) == (rp.value, rp.mask, rp.log2)
        for x in (0, 1, 63, 64, 65, 1000, 4097):
            for meth in ("round_down", "round_up", "div", "mod",
                         "is_aligned"):
                assert getattr(p, meth)(x) == getattr(rp, meth)(x)
    for bad in (0, 3, 100):
        assert _raised(lambda: tmath.Pow2(bad)) == \
            _raised(lambda: ref.math.Pow2(bad))
    for d in (1, 7, 100):
        f, rf = tmath.FastIntDiv(d), ref.math.FastIntDiv(d)
        for x in (0, 6, 7, 99, 1234, -5):
            assert (f.div(x), f.mod(x), f(x)) == (rf.div(x), rf.mod(x), rf(x))
    assert _raised(lambda: tmath.FastIntDiv(0)) == \
        _raised(lambda: ref.math.FastIntDiv(0))
    s, rs = tmath.Seive(1000), ref.math.Seive(1000)
    np.testing.assert_array_equal(s.get_primes(), rs.get_primes())
    assert s.get_num_primes() == rs.get_num_primes() == 168
    assert [s.is_prime(k) for k in range(1001)] == \
        [rs.is_prime(k) for k in range(1001)]
    assert _raised(lambda: s.is_prime(1001)) == \
        _raised(lambda: rs.is_prime(1001))


def test_product_of_lists_matches(ref):
    args = ([1, 2], "ab", [None, 0.5, 3])
    assert tit.product_of_lists(*args) == ref.it.product_of_lists(*args)


# -- architecture -----------------------------------------------------------------

def test_arch_query_and_gate(ref):
    a = tarch.TpuArch("NVIDIA H100 80GB HBM3", (9, 0))
    assert a.gen == 90 and not a.lite
    assert tarch.TpuArch("sm_90a").gen == 90 == a.gen
    assert a == tarch.TpuArch("sm_90") and hash(a) == hash(tarch.TpuArch(
        "sm_90"))
    assert tarch.TpuArch("cpu").gen == ref.arch.TpuArch("cpu").gen == 0
    if not torch.cuda.is_available():
        assert tarch.runtime_arch().gen == ref.arch.runtime_arch().gen == 0
    # the gate keeps the reference's semantics, gen 0 included
    gens = [0, 4, 5, 6, 80, 90]
    for lo, hi, unknown in [(0, None, True), (5, None, True),
                            (5, 6, False), (90, None, False),
                            (80, 89, True)]:
        g, rg = tarch.ArchRange(lo, hi, unknown), ref.arch.ArchRange(
            lo, hi, unknown)
        for gen in gens:
            t = tarch.TpuArch(f"sm_{gen}" if gen else "cpu")
            r = ref.arch.TpuArch(f"TPU v{gen}" if gen else "cpu")
            assert (t.gen, r.gen) == (gen, gen)
            assert g.contains(t) == rg.contains(r)


def test_capability_figures_come_from_the_card():
    assert tarch.mxu_dim() == 128       # wgmma_tile.cuh's kBN
    if not torch.cuda.is_available():
        for fn in (tarch.vmem_bytes, tarch.vreg_shape):
            with pytest.raises(tres.DeviceUnavailableError):
                fn()
    with pytest.raises(tres.DeviceUnavailableError):
        tarch.vmem_bytes(device="cpu")


# -- the precision ladder -----------------------------------------------------------

def test_ladder_matches(ref):
    assert tnum.LADDER == ref.num.LADDER
    for tier in list(tnum.LADDER) + ["bogus", "HIGH"]:
        assert tnum.next_tier(tier) == ref.num.next_tier(tier)
    assert _raised(lambda: tnum.tier_scope("bogus").__enter__()) == \
        _raised(lambda: ref.num.tier_scope("bogus").__enter__())


def test_tier_scope_and_escalation():
    seen = []

    def compute():
        seen.append((tprec.current_mode(),
                     torch.backends.cuda.matmul.allow_tf32))
        return len(seen)

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for tier, up in (("default", "high"), ("high", "highest")):
            with tnum.tier_scope(tier):
                assert tnum.next_tier() == up
                rerun = tnum.matmul_escalation(compute, op="gemm")
                rerun()
                assert seen[-1] == (up, False)
        with tnum.tier_scope("highest"):
            assert tnum.matmul_escalation(compute) is None
        with tnum.tier_scope("f64"):
            assert tprec.current_mode() == tprec.get_matmul_precision()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_escalated_gemm_gives_the_higher_tiers_bits():
    from raft_tpu_torch.linalg import gemm

    rng = np.random.default_rng(SEED)
    a, b = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            for s in ((33, 70), (70, 17)))
    with tnum.tier_scope("default"):
        got = tnum.matmul_escalation(lambda: gemm(None, a, b))()
        low = gemm(None, a, b)
    with tnum.tier_scope("high"):
        want = gemm(None, a, b)
    assert torch.equal(got, want) and not torch.equal(low, want)


def test_f64_host_matches(ref):
    x = np.random.default_rng(SEED).random((3, 4), dtype=np.float32)
    got = tnum.f64_host(torch.from_numpy(x), x.tolist())
    want = ref.num.f64_host(x, x.tolist())
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, w)
    bf = torch.from_numpy(x).to(torch.bfloat16)
    assert tnum.f64_host(bf).dtype == np.float64


# -- the vector caches -------------------------------------------------------------

def _state(st):
    return [np.asarray(st.keys), np.asarray(st.time), np.asarray(st.store),
            np.asarray(st.clock)]


def _tstate(st):
    return [st.keys.numpy(), st.time.numpy(), st.store.numpy(),
            st.clock.numpy()]


def _distinct_set_batches(rng, n_sets, n_batches, size, n_keys=4000):
    """Batches of distinct keys, no two in one set (the batch contract
    under which the reference's contents are specified), with reuse
    across batches and a few negative keys."""
    out = []
    for _ in range(n_batches):
        keys = rng.permutation(n_keys)
        _, first = np.unique(keys % n_sets, return_index=True)
        keys = keys[np.sort(first)][:size].astype(np.int32)
        keys[rng.random(keys.size) < 0.1] *= -1
        keys[keys == 0] = -3
        out.append(keys)
    return out


def test_capacity_rounding_matches(ref):
    h = tres.device_resources("cpu")
    for cap, assoc in ((100, 32), (64, 32), (5, 8), (1, 32)):
        v = tcache.VectorCache(3, cap, assoc, res=h)
        rv = ref.cache.VectorCache(3, cap, assoc)
        assert (v.n_sets, v.capacity, v.associativity) == \
            (rv.n_sets, rv.capacity, rv.associativity)
        st = tcache.device_cache_init(3, cap, assoc, res=h)
        rst = ref.cache.device_cache_init(3, cap, assoc)
        assert (st.n_sets, st.associativity) == (rst.n_sets,
                                                 rst.associativity)


@pytest.mark.parametrize("cap,assoc,n_vec", [(256, 8, 5), (300, 32, 3)])
def test_device_cache_sequence_matches(ref, cap, assoc, n_vec):
    import jax.numpy as jnp

    rng = np.random.default_rng(SEED + cap)
    h = tres.device_resources("cpu")
    st = tcache.device_cache_init(n_vec, cap, assoc, res=h)
    rst = ref.cache.device_cache_init(n_vec, cap, assoc)
    prev = np.zeros(0, np.int32)
    for i, keys in enumerate(_distinct_set_batches(rng, st.n_sets, 12,
                                                   st.n_sets)):
        if i % 3 == 2:
            # the last batch's keys (hits, and misses for its negative
            # keys) and fresh ones (misses, mostly), repeats allowed
            keys = np.concatenate([prev[::-1], keys[:7], prev[:3]])
            vecs, hit, st = tcache.device_cache_lookup(st, keys)
            rvecs, rhit, rst = ref.cache.device_cache_lookup(rst, keys)
            np.testing.assert_array_equal(hit.numpy(), np.asarray(rhit))
            np.testing.assert_array_equal(vecs.numpy(), np.asarray(rvecs))
            assert hit.any() and not hit.all()
        else:
            vecs = rng.standard_normal((keys.size, n_vec)).astype(np.float32)
            st = tcache.device_cache_insert(st, keys, vecs)
            rst = ref.cache.device_cache_insert(rst, jnp.asarray(keys),
                                                jnp.asarray(vecs))
            prev = keys
        for got, want in zip(_tstate(st), _state(rst)):
            np.testing.assert_array_equal(got, want)


def test_carried_state_continues_the_same(ref):
    import jax.numpy as jnp

    rng = np.random.default_rng(SEED)
    h = tres.device_resources("cpu")
    rst = ref.cache.device_cache_init(4, 128, 16)
    batches = _distinct_set_batches(rng, rst.n_sets, 6, rst.n_sets)
    for keys in batches[:3]:
        vecs = rng.standard_normal((keys.size, 4)).astype(np.float32)
        rst = ref.cache.device_cache_insert(rst, jnp.asarray(keys),
                                            jnp.asarray(vecs))
    st = interop.device_cache_state_from_numpy(*_state(rst), res=h)
    for keys in batches[3:]:
        vecs = rng.standard_normal((keys.size, 4)).astype(np.float32)
        st = tcache.device_cache_insert(st, keys, vecs)
        rst = ref.cache.device_cache_insert(rst, jnp.asarray(keys),
                                            jnp.asarray(vecs))
        out, hit, st = tcache.device_cache_lookup(st, keys[::-1].copy())
        rout, rhit, rst = ref.cache.device_cache_lookup(
            rst, jnp.asarray(keys[::-1].copy()))
        np.testing.assert_array_equal(out.numpy(), np.asarray(rout))
    for got, want in zip(_tstate(st), _state(rst)):
        np.testing.assert_array_equal(got, want)


def test_one_writer_a_slot_and_empty_batches():
    """Two rows aimed at one (set, way): the later row's key and vector
    win, never a mix; an all-negative or empty batch writes nothing."""
    h = tres.device_resources("cpu")
    st = tcache.device_cache_init(2, 8, 4, res=h)     # 2 sets
    keys = torch.tensor([2, 4, -1, 6, 8, 10], dtype=torch.int32)
    vecs = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    st = tcache.device_cache_insert(st, keys, vecs)
    # each row picks its set's LRU way in the state before the batch, so
    # all five set-0 keys pick way 0 and the last (10) wins
    assert st.keys[0].tolist() == [10, -1, -1, -1]
    assert st.store[0, 0].tolist() == [10.0, 11.0]
    before = [t.clone() for t in (st.keys, st.time, st.store)]
    st = tcache.device_cache_insert(st, [-5, -7], torch.zeros(2, 2))
    st = tcache.device_cache_insert(st, torch.zeros(0, dtype=torch.int32),
                                    torch.zeros(0, 2))
    _, hit, st = tcache.device_cache_lookup(st, [-1, 3])
    assert not hit.any() and int(st.clock) == 4
    for b, a in zip(before, (st.keys, st.time, st.store)):
        assert torch.equal(a, b)


def test_vector_cache_matches(ref):
    h = tres.device_resources("cpu")
    rng = np.random.default_rng(SEED)
    v, rv = tcache.VectorCache(3, 40, 4, res=h), ref.cache.VectorCache(3, 40,
                                                                       4)
    table = rng.standard_normal((200, 3)).astype(np.float32)

    def fn(keys):
        return torch.from_numpy(table[np.asarray(keys)])

    def rfn(keys):
        return table[np.asarray(keys)]

    for _ in range(3):
        keys = rng.choice(60, 25, replace=False).astype(np.int32)
        got = v.get_or_compute(keys, fn)
        want = rv.get_or_compute(keys, rfn)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), table[keys])
        for name in ("keys", "time", "store"):
            np.testing.assert_array_equal(getattr(v, name).numpy(),
                                          np.asarray(getattr(rv, name)))
        assert v._clock == rv._clock
    keys = np.array([5, 5, 7, -1], np.int32)
    np.testing.assert_array_equal(v.get_cache_idx(keys).numpy(),
                                  np.asarray(rv.get_cache_idx(keys)))
    slots = v.assign_cache_idx(keys)
    np.testing.assert_array_equal(slots.numpy(),
                                  np.asarray(rv.assign_cache_idx(keys)))
    np.testing.assert_array_equal(v.get_vecs(slots).numpy(),
                                  np.asarray(rv.get_vecs(np.asarray(slots))))


def test_device_cache_refuses_a_tensor_elsewhere():
    st = tcache.device_cache_init(2, 8, 4, res=tres.device_resources("cpu"))
    if torch.cuda.is_available():
        with pytest.raises(ValueError):
            tcache.device_cache_lookup(st, torch.zeros(2, dtype=torch.int32,
                                                       device="cuda"))
    if not torch.cuda.is_available():
        with pytest.raises(tres.DeviceUnavailableError):
            tcache.device_cache_init(2, 8)


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
def test_device_cache_on_card_equals_the_cpu(card):
    rng = np.random.default_rng(SEED)
    states = {d: tcache.device_cache_init(
        64, 4096, 32, res=tres.device_resources(d)) for d in ("cpu", card)}
    for _ in range(8):
        keys = rng.choice(20000, 512, replace=False).astype(np.int32)
        vecs = rng.standard_normal((512, 64)).astype(np.float32)
        outs = {}
        for d, st in states.items():
            tcache.device_cache_insert(st, keys, vecs)
            outs[d] = tcache.device_cache_lookup(st, keys[::-1].copy())
        assert torch.equal(outs["cpu"][1], outs[card][1].cpu())
        assert torch.equal(outs["cpu"][0], outs[card][0].cpu())
    for name in ("keys", "time", "store", "clock"):
        assert torch.equal(getattr(states["cpu"], name),
                           getattr(states[card], name).cpu())


@pytest.mark.cuda
def test_arch_figures_on_card(card):
    a = tarch.runtime_arch()
    major, minor = torch.cuda.get_device_capability(0)
    assert a.gen == major * 10 + minor
    assert tarch.vmem_bytes() == torch.cuda.get_device_properties(
        0).shared_memory_per_block_optin
    assert tarch.vreg_shape() == (1, 32)
