"""The port's dense linalg layer (raft_tpu_torch.linalg, core.operators,
core.kvp, util.precision.resolve) against the reference package on the
same seeded numpy inputs, CPU tensors on the port's side (the keyed sums
run ``csr_spmm.cu``'s plain version there).

Tolerances: f32 results that both packages form by the same arithmetic
in another order agree to 1e-5 relative (1e-4 where a decomposition or
an f32 Gram matrix stands between input and result, 1e-12 in f64);
integer keyed sums are exact. gemm holds each tier within its own error
of an f64 product over |A|·|B|: 'highest' 1e-6 (f32), 'high' 2e-5
(bf16x3, the dropped lo·lo term about 2^-18), 'default' 1e-2 (one bf16
pass, about 2^-8 an operand). Eigen- and singular vectors are compared
up to sign; the randomized SVD's sketch is torch's stream, not JAX's,
so it is held to the exact singular values instead (1e-4 relative on a
spectrum with a gap).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import n, t
from raft_tpu import linalg as rl
from raft_tpu.core import kvp as rkvp
from raft_tpu.core import operators as rops
from raft_tpu.util import precision as rprec
from raft_tpu_torch import device_resources
from raft_tpu_torch import linalg as tl
from raft_tpu_torch.core import kvp as tkvp
from raft_tpu_torch.core import operators as tops
from raft_tpu_torch.core.guards import ConvergenceError
from raft_tpu_torch.linalg import eig as teig
from raft_tpu_torch.util import precision as tprec

RES = device_resources("cpu")


def _rng(seed=42):
    return np.random.default_rng(seed)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(n(got).astype(np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _cols_up_to_sign(got, want, atol):
    g, w = n(got).astype(np.float64), np.asarray(want, np.float64)
    signs = np.sign((g * w).sum(0))
    signs[signs == 0] = 1
    np.testing.assert_allclose(g * signs[None, :], w, atol=atol)


# -- util.precision.resolve and the operator vocabulary -----------------------


@pytest.mark.parametrize("spelling", [None, "default", "HIGH", "highest",
                                      "bfloat16_3x", "f32", "fastest"])
def test_resolve_names_the_reference_tier(spelling):
    want = rprec.resolve(spelling)
    got = tprec.resolve(spelling)
    if spelling is None:
        assert got is None and want is None
    else:
        assert got == {"DEFAULT": "default", "HIGH": "high",
                       "HIGHEST": "highest"}[want.name]


def test_resolve_rejects_unknown_spellings():
    for bogus in ("bogus", "fp8"):
        with pytest.raises(ValueError):
            rprec.resolve(bogus)
        with pytest.raises(ValueError):
            tprec.resolve(bogus)


_UNARY = ["identity_op", "abs_op", "sq_op", "sqrt_op", "nz_op"]
_BINARY = ["add_op", "sub_op", "mul_op", "div_op", "div_checkzero_op",
           "pow_op", "mod_op", "min_op", "max_op", "sqdiff_op", "absdiff_op"]


@pytest.mark.parametrize("name", _UNARY + _BINARY)
def test_operators_match_the_reference(name):
    rng = _rng(1)
    a = rng.uniform(0.5, 3.0, 12).astype(np.float32)
    b = rng.uniform(-2.0, 2.0, 12).astype(np.float32)
    b[3] = 0.0
    args = (a,) if name in _UNARY else (a, b)
    want = getattr(rops, name)(*(jnp.asarray(x) for x in args))
    got = getattr(tops, name)(*(t(x) for x in args))
    _close(got, want)


def test_operator_combinators_and_kvp_reductions():
    a = np.array([3.0, 1.0, 2.0, 1.0], np.float32)
    for mod, conv in ((rops, jnp.asarray), (tops, t)):
        f = mod.compose_op(mod.sqrt_op, mod.add_const_op(1.0), mod.sq_op)
        _close(f(conv(a)), np.sqrt(a * a + 1.0))
        g = mod.map_args_op(mod.add_op, mod.sq_op, mod.abs_op)
        _close(g(conv(a), conv(-a)), a * a + a)
        assert mod.const_op(7)(conv(a)) == 7
        _close(mod.plug_const_op(mod.sub_op, 1.0, side="left")(conv(a)),
               1.0 - a)
        for c, fn in ((2.0, mod.sub_const_op), (2.0, mod.mul_const_op),
                      (2.0, mod.div_const_op), (2.0, mod.pow_const_op)):
            _close(fn(c)(conv(a)), {mod.sub_const_op: a - c,
                                    mod.mul_const_op: a * c,
                                    mod.div_const_op: a / c,
                                    mod.pow_const_op: a ** c}[fn])
        assert mod.void_op(conv(a)) is None
    # ties: the lower key wins on equal values, in both packages
    ka, va = np.array([4, 2, 7]), np.array([1.0, 5.0, 2.0], np.float32)
    kb, vb = np.array([3, 9, 1]), np.array([1.0, 5.0, 2.5], np.float32)
    for op in ("argmin_op", "argmax_op"):
        rk, rv = getattr(rops, op)(rkvp.make_kvp(ka, va),
                                   rkvp.make_kvp(kb, vb))
        tk, tv = getattr(tops, op)(tkvp.make_kvp(t(ka), t(va)),
                                   tkvp.make_kvp(t(kb), t(vb)))
        np.testing.assert_array_equal(n(tk), n(rk))
        np.testing.assert_array_equal(n(tv), n(rv))
        assert tops.key_op((tk, tv)) is tk and tops.value_op((tk, tv)) is tv


# -- blas -------------------------------------------------------------------

GEMM_TOL = {"highest": 1e-6, "high": 2e-5, "default": 1e-2}


@pytest.mark.parametrize("tier", ["default", "high", "highest"])
@pytest.mark.parametrize("m,k,nn,trans_a,trans_b",
                         [(32, 16, 24, False, False), (17, 65, 33, True, False),
                          (40, 200, 8, False, True), (64, 64, 64, True, True)])
def test_gemm_tier_within_its_error_of_f64(tier, m, k, nn, trans_a, trans_b):
    rng = _rng(m * 7 + k)
    a = rng.normal(size=(k, m) if trans_a else (m, k)).astype(np.float32)
    b = rng.normal(size=(nn, k) if trans_b else (k, nn)).astype(np.float32)
    opa = a.T if trans_a else a
    opb = b.T if trans_b else b
    exact = opa.astype(np.float64) @ opb.astype(np.float64)
    mass = np.abs(opa).astype(np.float64) @ np.abs(opb).astype(np.float64)
    got = tl.gemm(RES, t(a), t(b), trans_a=trans_a, trans_b=trans_b,
                  precision=tier)
    assert got.dtype == torch.float32 and got.shape == (m, nn)
    err = np.abs(n(got) - exact)
    assert (err <= GEMM_TOL[tier] * mass + 1e-6).all(), err.max()
    # the tier in effect applies when none is given
    with tprec.scope(tier):
        assert torch.equal(tl.gemm(RES, t(a), t(b), trans_a=trans_a,
                                   trans_b=trans_b), got)
    if tier == "highest":
        want = rl.gemm(None, a, b, trans_a=trans_a, trans_b=trans_b,
                       precision=tier)
        _close(got, want, rtol=1e-5, atol=1e-5)


def test_gemm_gram_high_splits_once_and_bf16_f64_inputs():
    rng = _rng(3)
    a = rng.normal(size=(50, 12)).astype(np.float32)
    ta = t(a)
    got = tl.gemm(RES, ta, ta, trans_a=True, precision="high")
    exact = a.T.astype(np.float64) @ a.astype(np.float64)
    assert np.abs(n(got) - exact).max() <= 2e-5 * np.abs(exact).max() * 3
    # bf16 operands: one pass with an f32 accumulation, bf16 result
    ab = ta.to(torch.bfloat16)
    out = tl.gemm(RES, ab, ab, trans_a=True)
    assert out.dtype == torch.bfloat16
    _close(out.float(), (ab.float().T @ ab.float()).to(torch.bfloat16).float())
    # f64 accumulates in f64 at every tier
    a64 = rng.normal(size=(9, 7))
    for tier in ("default", "high", "highest"):
        _close(tl.gemm(RES, t(a64), t(a64.T), precision=tier),
               rl.gemm(None, a64, a64.T, precision=tier), rtol=1e-12,
               atol=1e-12)
    with pytest.raises(ValueError):
        tl.gemm(RES, ta, ta, trans_a=True, precision="bogus")
    for mode in ("check", "recover"):
        with pytest.raises(NotImplementedError, match="item 13"):
            tl.gemm(RES, ta, ta, trans_a=True, guard_mode=mode)


def test_gemm_alpha_beta_c_and_the_small_blas():
    rng = _rng(4)
    A = rng.normal(size=(20, 10)).astype(np.float32)
    B = rng.normal(size=(20, 8)).astype(np.float32)
    C = rng.normal(size=(10, 8)).astype(np.float32)
    x = rng.normal(size=10).astype(np.float32)
    y = rng.normal(size=20).astype(np.float32)
    _close(tl.gemm(RES, t(A), t(B), alpha=0.5, beta=2.0, C=t(C),
                   trans_a=True, precision="highest"),
           rl.gemm(None, A, B, alpha=0.5, beta=2.0, C=C, trans_a=True,
                   precision="highest"), atol=1e-5)
    _close(tl.gemv(RES, t(A), t(x), alpha=2.0, beta=0.5, y=t(y)),
           rl.gemv(None, A, x, alpha=2.0, beta=0.5, y=y), atol=1e-5)
    _close(tl.gemv(RES, t(A), t(y), trans=True),
           rl.gemv(None, A, y, trans=True), atol=1e-5)
    _close(tl.axpy(RES, 3.0, t(y), t(y)), rl.axpy(None, 3.0, y, y))
    _close(tl.dot(RES, t(x), t(x)), rl.dot(None, x, x))
    xb = t(x).to(torch.bfloat16)
    assert tl.dot(RES, xb, xb).dtype == torch.bfloat16
    np.testing.assert_array_equal(n(tl.transpose(RES, t(A))), A.T)
    assert tl.transpose(RES, t(A)).is_contiguous()
    _close(tl.scal(RES, -2.0, t(x)), rl.scal(None, -2.0, x))
    _close(tl.mean_squared_error(RES, t(A), t(A[::-1].copy()), weight=3.0),
           rl.mean_squared_error(None, A, A[::-1], weight=3.0))


# -- reductions -------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16,
                                   np.int32])
@pytest.mark.parametrize("op", ["add_op", "min_op", "max_op", "mul_op"])
def test_reduce_builtin_ops(dtype, op):
    rng = _rng(5)
    x = (rng.integers(1, 4, size=(13, 7)) if dtype == np.int32
         else rng.uniform(0.5, 1.5, size=(13, 7))).astype(dtype)
    for apply in (rl.ALONG_ROWS, rl.ALONG_COLUMNS):
        for init in (None, 2):
            kw = dict(apply=apply, init=init, reduce_op=getattr(rops, op),
                      main_op=rops.sq_op, final_op=rops.abs_op)
            want = rl.reduce(None, x, **kw)
            kw["reduce_op"] = getattr(tops, op)
            kw["main_op"], kw["final_op"] = tops.sq_op, tops.abs_op
            got = tl.reduce(RES, t(x), **kw)
            # the input's dtype (the reference widens int32 to int64
            # only with jax_enable_x64, which the test session sets)
            assert n(got).dtype == dtype
            rtol = 2e-3 if dtype == np.float16 else 1e-5
            _close(got, want, rtol=rtol, atol=0)


def test_reduce_custom_op_inplace_and_wrappers():
    rng = _rng(6)
    x = rng.normal(size=(9, 11)).astype(np.float32)
    hyp = lambda a, b: a + b + 0.0 * a * b          # noqa: E731
    for apply in (rl.ALONG_ROWS, rl.ALONG_COLUMNS):
        want = rl.reduce(None, x, apply=apply, init=0.5, reduce_op=hyp)
        _close(tl.reduce(RES, t(x), apply=apply, init=0.5, reduce_op=hyp),
               want, atol=1e-5)
    with pytest.raises(ValueError, match="init"):
        tl.reduce(RES, t(x), reduce_op=hyp)
    with pytest.raises(ValueError):
        tl.reduce(RES, t(x), apply="diagonal")
    out = rng.normal(size=9).astype(np.float32)
    _close(tl.reduce(RES, t(x), inplace=True, out=t(out)),
           rl.reduce(None, x, inplace=True, out=out))
    _close(tl.coalesced_reduction(RES, t(-x), reduce_op=tops.max_op),
           rl.coalesced_reduction(None, -x, reduce_op=rops.max_op))
    _close(tl.strided_reduction(RES, t(x), init=1.0),
           rl.strided_reduction(None, x, init=1.0))


def _keyed_ref(x, keys, n_keys, w=None):
    ref = np.zeros((n_keys,) + x.shape[1:], np.float64)
    ok = (keys >= 0) & (keys < n_keys)
    xw = x.astype(np.float64) * (1.0 if w is None else w[:, None])
    np.add.at(ref, keys[ok].astype(np.int64), xw[ok])
    return ref


@pytest.mark.parametrize("case", ["f32", "f32_weighted", "f64", "f64_weighted",
                                  "bf16", "f16", "uint8_keys",
                                  "out_of_range", "many_keys", "empty_keys"])
def test_reduce_rows_by_key_through_the_csr_route(case):
    rng = _rng(7)
    m, d, nk = 300, 6, 17
    dtype = {"f64": np.float64, "f64_weighted": np.float64}.get(case,
                                                                 np.float32)
    x = rng.normal(size=(m, d)).astype(dtype)
    keys = rng.integers(0, nk, size=m).astype(np.int32)
    w = None
    if case.endswith("weighted"):
        w = rng.uniform(0.1, 2.0, size=m).astype(dtype)
    if case == "uint8_keys":
        nk = 300
        keys = rng.integers(0, 250, size=m).astype(np.uint8)
    if case == "out_of_range":
        keys = rng.integers(-2, nk + 3, size=m).astype(np.int32)
    if case == "many_keys":
        nk = 5000
        keys = rng.integers(0, nk, size=m).astype(np.int32)
    if case == "empty_keys":
        keys[:] = 3
    tx = t(x)
    if case in ("bf16", "f16"):
        tx = tx.to(torch.bfloat16 if case == "bf16" else torch.float16)
    got = tl.reduce_rows_by_key(RES, tx, t(keys), nk,
                                weights=None if w is None else t(w))
    assert got.dtype == tx.dtype and got.shape == (nk, d)
    exact = _keyed_ref(tx.double().numpy(), keys, nk, w)
    mass = _keyed_ref(np.abs(tx.double().numpy()), keys, nk,
                      None if w is None else np.abs(w))
    rel = {"bf16": 8e-3, "f16": 1e-3}.get(case, 1e-12 if dtype == np.float64
                                          else 2e-6)
    assert (np.abs(n(got.double()) - exact) <= rel * mass + rel).all()
    if case in ("bf16", "f16"):
        return
    want = rl.reduce_rows_by_key(None, x, keys, nk, weights=w)
    _close(got, want, rtol=1e-12 if dtype == np.float64 else 3e-5,
           atol=1e-12 if dtype == np.float64 else 3e-4)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_keyed_sums_of_integers_are_exact_in_their_dtype(dtype):
    rng = _rng(8)
    x = rng.integers(-1000, 1000, size=(200, 5)).astype(dtype)
    keys = rng.integers(-1, 9, size=200).astype(np.int32)
    w = rng.integers(0, 3, size=200).astype(dtype)
    for weights in (None, w):
        got = tl.reduce_rows_by_key(RES, t(x), t(keys), 8,
                                    weights=None if weights is None
                                    else t(weights))
        want = rl.reduce_rows_by_key(None, x, keys, 8, weights=weights)
        assert n(got).dtype == dtype
        np.testing.assert_array_equal(n(got), np.asarray(want))
    got = tl.reduce_cols_by_key(RES, t(x.T.copy()), t(keys), 8)
    np.testing.assert_array_equal(
        n(got), np.asarray(rl.reduce_cols_by_key(None, x.T, keys, 8)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_reduce_cols_by_key(dtype):
    rng = _rng(9)
    x = rng.normal(size=(12, 40)).astype(dtype)
    keys = rng.integers(0, 6, size=40).astype(np.int32)
    got = tl.reduce_cols_by_key(RES, t(x), t(keys), 6)
    assert got.shape == (12, 6) and n(got).dtype == dtype
    _close(got, rl.reduce_cols_by_key(None, x, keys, 6),
           rtol=1e-12 if dtype == np.float64 else 1e-5, atol=1e-6)


def test_keyed_rows_go_through_the_spmm_wrapper(monkeypatch):
    """Float keyed sums take the CSR product of ``grid_spmv._spmm`` (the
    kernel on a CUDA tensor), grouped by a stable sort."""
    import importlib

    treduce = importlib.import_module("raft_tpu_torch.linalg.reduce")
    calls = []
    real = treduce._spmm

    def spy(indptr, indices, data, b, n_rows):
        calls.append((n(indptr), n(indices), b.shape, n_rows))
        return real(indptr, indices, data, b, n_rows)

    monkeypatch.setattr(treduce, "_spmm", spy)
    x = _rng(10).normal(size=(6, 3)).astype(np.float32)
    keys = np.array([2, 0, 2, 5, 0, 2], np.int32)
    tl.reduce_rows_by_key(RES, t(x), t(keys), 3)
    indptr, indices, shape, rows = calls[0]
    assert rows == 3 and shape == (6, 3)
    np.testing.assert_array_equal(indptr, [0, 2, 2, 5])
    # row 3's key (5) is out of range: it sorts past indptr[-1], unread
    np.testing.assert_array_equal(indices, [1, 4, 0, 2, 5, 3])


# -- map, eltwise, matrix_vector_op, norms ------------------------------------


def test_maps():
    rng = _rng(11)
    a = rng.normal(size=(4, 5)).astype(np.float32)
    b = rng.normal(size=(4, 5)).astype(np.float32)
    _close(tl.map(RES, lambda x, y: x * y + 1, t(a), t(b)),
           rl.map(None, lambda x, y: x * y + 1, a, b))
    for shape_or_ref in (20, (4, 5), a):
        ref_arg = t(a) if shape_or_ref is a else shape_or_ref
        got = tl.map_offset(RES, lambda i: i * 2, ref_arg)
        want = rl.map_offset(None, lambda i: i * 2, shape_or_ref)
        np.testing.assert_array_equal(n(got), np.asarray(want))
    _close(tl.map_offset(RES, lambda i, x: i + x, (4, 5), t(a)),
           rl.map_offset(None, lambda i, x: i + x, (4, 5), a))
    _close(tl.map_reduce(RES, lambda x: x * x, None, 1.5, t(a)),
           rl.map_reduce(None, lambda x: x * x, None, 1.5, a), atol=1e-5)
    _close(tl.map_reduce(RES, lambda x: x, torch.maximum, -10.0, t(a)),
           rl.map_reduce(None, lambda x: x, jnp.maximum, -10.0, a))
    _close(tl.map_then_reduce(RES, lambda x, y: x - y, t(a), t(b)),
           rl.map_then_reduce(None, lambda x, y: x - y, a, b), atol=1e-5)
    _close(tl.map_then_reduce(RES, lambda x: x, t(a[0])),
           rl.map_then_reduce(None, lambda x: x, a[0]), atol=1e-6)


_ELT = {"add": 2, "subtract": 2, "multiply": 2, "divide": 2, "power": 2,
        "add_scalar": 1, "subtract_scalar": 1, "multiply_scalar": 1,
        "divide_scalar": 1, "power_scalar": 1, "sqrt": 0}


@pytest.mark.parametrize("name", sorted(_ELT))
def test_eltwise(name):
    rng = _rng(12)
    a = rng.uniform(0.5, 2.0, size=(3, 4)).astype(np.float32)
    b = rng.uniform(0.5, 2.0, size=(3, 4)).astype(np.float32)
    extra = {2: (b,), 1: (1.5,), 0: ()}[_ELT[name]]
    want = getattr(rl, name)(None, a, *extra)
    got = getattr(tl, name)(RES, t(a), *(t(e) if isinstance(e, np.ndarray)
                                         else e for e in extra))
    _close(got, want)


def test_elementwise_op_forms_and_matrix_vector_op():
    rng = _rng(13)
    a = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=(3, 4)).astype(np.float32)
    _close(tl.unary_op(RES, t(a), lambda x: x * 3),
           rl.unary_op(None, a, lambda x: x * 3))
    _close(tl.binary_op(RES, t(a), t(b), lambda x, y: x - 2 * y),
           rl.binary_op(None, a, b, lambda x, y: x - 2 * y))
    _close(tl.ternary_op(RES, t(a), t(b), t(a), lambda x, y, z: x * y + z),
           rl.ternary_op(None, a, b, a, lambda x, y, z: x * y + z))
    got = tl.write_only_unary_op(RES, (2, 3), lambda i: i * 0.5,
                                 dtype=torch.float64)
    assert got.dtype == torch.float64
    _close(got, rl.write_only_unary_op(None, (2, 3), lambda i: i * 0.5))
    vr = rng.normal(size=4).astype(np.float32)
    vc = rng.normal(size=3).astype(np.float32)
    for apply, v in ((rl.ALONG_ROWS, vr), (rl.ALONG_COLUMNS, vc)):
        _close(tl.matrix_vector_op(RES, t(a), t(v), lambda m, x: m * x,
                                   apply=apply),
               rl.matrix_vector_op(None, a, v, lambda m, x: m * x,
                                   apply=apply))
        _close(tl.matrix_vector_op(RES, t(a), t(v), lambda m, x, y: m + x * y,
                                   apply=apply, vec2=t(v)),
               rl.matrix_vector_op(None, a, v, lambda m, x, y: m + x * y,
                                   apply=apply, vec2=v))
    with pytest.raises(ValueError):
        tl.matrix_vector_op(RES, t(a), t(vr), lambda m, x: m, apply="bogus")


@pytest.mark.parametrize("norm_type", ["l1", "l2", "linf"])
def test_norms_and_normalize(norm_type):
    rng = _rng(14)
    x = rng.normal(size=(7, 5)).astype(np.float32)
    x[2] = 0.0
    x[4] = 1e-9
    for sqrt in (False, True):
        _close(tl.row_norm(RES, t(x), norm_type, sqrt=sqrt),
               rl.row_norm(None, x, norm_type, sqrt=sqrt))
        _close(tl.col_norm(RES, t(x), norm_type, sqrt=sqrt),
               rl.col_norm(None, x, norm_type, sqrt=sqrt))
    got = tl.normalize(RES, t(x), norm_type)
    _close(got, rl.normalize(None, x, norm_type))
    assert not got[2].any() and not got[4].any()      # the eps floor
    with pytest.raises(ValueError):
        tl.norm(RES, t(x), "l3")
    with pytest.raises(ValueError):
        tl.normalize(RES, t(x), "l3")


# -- decompositions ---------------------------------------------------------


def _sym(seed, k, dtype=np.float32):
    a = _rng(seed).normal(size=(k, k))
    return ((a + a.T) / 2).astype(dtype)


@pytest.mark.parametrize("k", [8, 33])
def test_eig_dc(k):
    a = _sym(15, k)
    w, v = tl.eig_dc(RES, t(a))
    rw, rv = rl.eig_dc(None, a)
    _close(w, rw, rtol=1e-4, atol=1e-4)
    _cols_up_to_sign(v, rv, atol=1e-3)


@pytest.mark.parametrize("k", [2, 7, 24])
def test_eig_jacobi(k):
    """Eigenpairs in f32; the convergence report in f64, where the
    off-diagonal norm (a difference of two sums of squares) resolves
    1e-7: in f32 its rounding alone is about 3e-4 of ||A||, so whether an
    f32 run reports convergence depends on the summation order."""
    a = _sym(16 + k, k)
    w, v = tl.eig_jacobi(RES, t(a), sweeps=20)
    rw, rv = rl.eig_jacobi(None, a, sweeps=20)
    _close(w, rw, rtol=1e-4, atol=1e-4)
    _cols_up_to_sign(v, rv, atol=1e-3)
    recon = n(v) @ np.diag(n(w)) @ n(v).T
    np.testing.assert_allclose(recon, a, atol=1e-4)
    a64 = a.astype(np.float64)
    w, v, rep = tl.eig_jacobi(RES, t(a64), return_report=True)
    rw, rv, rrep = rl.eig_jacobi(None, a64, return_report=True)
    _close(w, rw, rtol=1e-10, atol=1e-10)
    _cols_up_to_sign(v, rv, atol=1e-8)
    assert rep.converged and rrep.converged
    assert rep.n_iter == rrep.n_iter


def test_eig_jacobi_edges():
    # equal diagonal entries need the 45-degree rotation
    a = np.array([[2.0, 1.0], [1.0, 2.0]], np.float32)
    w, _ = tl.eig_jacobi(RES, t(a))
    _close(w, [1.0, 3.0], atol=1e-6)
    # the sweeps knob: one sweep is not enough at tol 1e-12
    b = _sym(17, 16)
    with pytest.raises(ConvergenceError):
        tl.eig_jacobi(RES, t(b), tol=1e-12, sweeps=1, strict=True)
    _, _, rep = tl.eig_jacobi(RES, t(b), tol=1e-12, sweeps=1,
                              return_report=True)
    _, _, rrep = rl.eig_jacobi(None, b, tol=1e-12, sweeps=1,
                               return_report=True)
    assert (rep.converged, rep.n_iter) == (rrep.converged, rrep.n_iter)
    assert tl.eig_jacobi(RES, t(b))[0].shape == (16,)
    # complex (Hermitian) input takes eig_dc, 1x1 is its own answer
    h = np.array([[2.0, 1j], [-1j, 2.0]], np.complex64)
    w, _, rep = tl.eig_jacobi(RES, t(h), return_report=True)
    assert rep.n_iter == 0
    _close(w, [1.0, 3.0], atol=1e-5)
    w, v = tl.eig_jacobi(RES, t(np.array([[4.0]], np.float32)))
    assert float(w[0]) == 4.0 and float(v[0, 0]) == 1.0


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("exact", [None, False, True])
def test_eig_sel(largest, exact):
    k = 48
    rng = _rng(18)
    q, _ = np.linalg.qr(rng.normal(size=(k, k)))
    spec = np.concatenate([np.linspace(10.0, 6.0, 5), np.linspace(
        1.0, -1.0, k - 10), np.linspace(-6.0, -10.0, 5)])
    a = ((q * spec) @ q.T).astype(np.float32)
    w, v = tl.eig_sel(RES, t(a), 4, largest=largest, exact=exact)
    rw, rv = rl.eig_sel(None, a, 4, largest=largest, exact=exact)
    _close(w, rw, rtol=1e-4, atol=1e-4)
    _cols_up_to_sign(v, rv, atol=2e-3)
    with pytest.raises(ValueError):
        tl.eig_sel(RES, t(a), 0)


def test_qr_and_cholesky_r1_update():
    rng = _rng(19)
    m = rng.normal(size=(12, 5)).astype(np.float32)
    q = tl.qr_get_q(RES, t(m))
    q2, r = tl.qr_get_qr(RES, t(m))
    rq, rr = rl.qr_get_qr(None, m)
    _cols_up_to_sign(q, rq, atol=1e-5)
    assert torch.equal(q, q2)
    np.testing.assert_allclose(n(q2) @ n(r), m, atol=1e-5)
    a = m.T @ m + np.eye(5, dtype=np.float32)
    full = np.linalg.cholesky(a.astype(np.float64))
    for lower in (True, False):
        L = np.zeros((5, 5), np.float32)
        for step in range(1, 6):
            prev = L if lower else L.T
            L_t = tl.cholesky_r1_update(RES, t(prev), t(a[:step, step - 1]),
                                        step, lower=lower)
            L_r = rl.cholesky_r1_update(None, prev, a[:step, step - 1], step,
                                        lower=lower)
            _close(L_t, L_r, atol=1e-5)
            L = n(L_t) if lower else n(L_t).T
        np.testing.assert_allclose(L, full, atol=1e-4)
    bad = np.array([[1.0, 2.0], [2.0, 1.0]], np.float32)
    L1 = n(tl.cholesky_r1_update(RES, t(np.zeros((2, 2), np.float32)),
                                 t(bad[:1, 0]), 1))
    got = tl.cholesky_r1_update(RES, t(L1), t(bad[:, 1]), 2)
    assert torch.isnan(got[1, 1])                  # negative pivot, eps 0
    floored = tl.cholesky_r1_update(RES, t(L1), t(bad[:, 1]), 2, eps=1e-3)
    _close(floored[1, 1], np.sqrt(1e-3), rtol=1e-6)
    _close(floored, rl.cholesky_r1_update(None, L1, bad[:, 1], 2, eps=1e-3))
    with pytest.raises(NotImplementedError, match="item 13"):
        tl.cholesky_r1_update(RES, t(L1), t(bad[:, 1]), 2, guard_mode="check")


@pytest.mark.parametrize("name", ["lstsq_svd_qr", "lstsq_svd_jacobi",
                                  "lstsq_eig", "lstsq_qr"])
def test_lstsq(name):
    rng = _rng(20)
    A = rng.normal(size=(60, 5))
    for b in (rng.normal(size=60), rng.normal(size=(60, 3))):
        want = np.linalg.lstsq(A, b, rcond=None)[0]
        got = getattr(tl, name)(RES, t(A), t(b))
        assert got.shape == want.shape
        _close(got, want, rtol=1e-8, atol=1e-8)
        _close(got, getattr(rl, name)(None, A, b), rtol=1e-8, atol=1e-8)
        got32 = getattr(tl, name)(RES, t(A.astype(np.float32)),
                                  t(b.astype(np.float32)))
        _close(got32, want, rtol=1e-3, atol=1e-3)
    with pytest.raises(ValueError, match="rows"):
        getattr(tl, name)(RES, t(A), t(np.ones(7)))
    with pytest.raises(ValueError, match="2-D"):
        getattr(tl, name)(RES, t(np.ones(7)), t(np.ones(7)))


def test_svd_routes_and_reconstruction():
    rng = _rng(21)
    a = rng.normal(size=(40, 9)).astype(np.float32)
    exact = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    for name in ("svd_qr", "svd_eig", "svd_jacobi"):
        u, s, v = getattr(tl, name)(RES, t(a))
        ru, rs, rv = getattr(rl, name)(None, a)
        _close(s, exact, rtol=1e-4, atol=1e-5)
        _close(s, rs, rtol=1e-4, atol=1e-5)
        _cols_up_to_sign(v, rv, atol=1e-3)
        _cols_up_to_sign(u, ru, atol=1e-3)
        assert tl.evaluate_svd_by_reconstruction(RES, t(a), u, s, v)
        _close(tl.svd_reconstruction(RES, u, s, v), a, atol=1e-4)
    u, s, v = tl.svd_qr(RES, t(a), full_matrices=True)
    assert u.shape == (40, 40) and v.shape == (9, 9)
    assert not tl.evaluate_svd_by_reconstruction(
        RES, t(a), u[:, :9], s * 2, v)


def test_rsvd_against_the_exact_singular_values():
    rng = _rng(22)
    q1, _ = np.linalg.qr(rng.normal(size=(120, 30)))
    q2, _ = np.linalg.qr(rng.normal(size=(30, 30)))
    spec = 0.7 ** np.arange(30)
    a = ((q1 * spec) @ q2.T).astype(np.float32)
    for fn, arg in ((tl.rsvd_fixed_rank, 6), (tl.randomized_svd, 6),
                    (tl.rsvd_perc, 0.2)):
        u, s, v = fn(RES, t(a), arg)
        assert u.shape == (120, 6) and s.shape == (6,) and v.shape == (30, 6)
        _close(s, spec[:6], rtol=1e-4, atol=1e-6)
        _, rs, _ = getattr(rl, fn.__name__)(None, a, arg)
        _close(s, rs, rtol=1e-4, atol=1e-6)
    from raft_tpu_torch.random.rng_state import RngState

    st = RngState(seed=5)
    first = tl.rsvd_fixed_rank(RES, t(a), 6, state=st)[1]
    assert st.base_subsequence == 1
    again = tl.rsvd_fixed_rank(RES, t(a), 6, state=RngState(seed=5))[1]
    assert torch.equal(first, again)
