"""The port's dense matrix utilities (raft_tpu_torch.matrix.{ops,
linewise_op, argminmax}) against the reference package on the same numpy
inputs, CPU tensors on the port's side.

Every comparison is exact (bit for bit, NaN where NaN): the functions
move, select or map values one at a time, and the sums (``l2_norm``,
``ratio``) run on integer-valued data, exact in any order. The one
exception is ``linspace`` in f32, held within 4 units in the last place
of its larger endpoint: XLA rewrites the reference's ``start·(1 - t) +
stop·t`` (it multiplies by a rounded ``1 / (n - 1)`` and folds ``stop /
(n - 1)`` into a constant), which no fixed order of f32 operations
repeats; each side rounds about 2 such units at most.
``sort_cols_per_row`` is held on rows with NaN, signed zeros, ties and
integer minima. ``sample_rows`` draws from another stream than the
reference's, so its rows are held to be distinct rows of the input.
"""

import numpy as np
import pytest
import torch

from _torch_util import n, t
from raft_tpu import matrix as rm
from raft_tpu.random import RngState as RState
from raft_tpu_torch import device_resources
from raft_tpu_torch import matrix as tm
from raft_tpu_torch.matrix import argminmax as targ
from raft_tpu_torch.random import RngState as TState

RES = device_resources("cpu")


def _rng(seed=5):
    return np.random.default_rng(seed)


def _same(got, want):
    g, w = n(got), np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


def _bits_equal(got, want):
    """Equal bit for bit (signed zeros and NaN payloads aside: NaN
    where NaN)."""
    g, w = n(got), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype
    nan = np.isnan(w)
    np.testing.assert_array_equal(np.isnan(g), nan)
    np.testing.assert_array_equal(g[~nan], w[~nan])
    np.testing.assert_array_equal(np.signbit(g[~nan]), np.signbit(w[~nan]))


def _ints_as_float(shape, seed=5):
    return _rng(seed).integers(-9, 10, shape).astype(np.float32)


_UNARY = ["copy", "get_diagonal", "col_reverse", "row_reverse", "sqrt",
          "upper_triangular", "lower_triangular", "l2_norm", "ratio"]


@pytest.mark.parametrize("name", _UNARY)
@pytest.mark.parametrize("shape", [(5, 5), (4, 7), (7, 3)])
def test_unary_ops_exact(name, shape):
    x = np.abs(_ints_as_float(shape)) + 1.0
    _same(getattr(tm, name)(RES, t(x)), getattr(rm, name)(None, x))


def test_diagonal_setters_and_maps():
    x = _ints_as_float((4, 6)) + 0.5
    v = np.array([1.5, -2.0, 3.0, 4.0, 9.0], np.float32)
    _same(tm.set_diagonal(RES, t(x), t(v)), rm.set_diagonal(None, x, v))
    _same(tm.invert_diagonal(RES, t(x)), rm.invert_diagonal(None, x))
    _same(tm.weighted_power(RES, t(x), 0.5, 3.0),
          rm.weighted_power(None, x, 0.5, 3.0))
    _same(tm.power(RES, t(x), 2.0), rm.power(None, x, 2.0))
    for setzero in (False, True):
        xz = x.copy()
        xz[1, 2] = 0.0
        xz[2, 3] = 1e-16
        _same(tm.reciprocal(RES, t(xz), 2.0, setzero),
              rm.reciprocal(None, xz, 2.0, setzero))
    xs = x.copy()
    xs[0, 0], xs[1, 1] = 1e-20, -1e-17
    _same(tm.zero_small_values(RES, t(xs)), rm.zero_small_values(None, xs))
    _same(tm.slice(RES, t(x), (1, 3), (2, 6)),
          rm.slice(None, x, (1, 3), (2, 6)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_eye_and_fill_exact(dtype):
    tdt = {np.float32: torch.float32, np.float64: torch.float64,
           np.int32: torch.int32}[dtype]
    _same(tm.eye(RES, 3, 5, dtype=tdt), rm.eye(None, 3, 5, dtype=dtype))
    _same(tm.eye(RES, 4, dtype=tdt), rm.eye(None, 4, dtype=dtype))
    _same(tm.fill(RES, (2, 3), 7, dtype=tdt),
          rm.fill(None, (2, 3), 7, dtype=dtype))


@pytest.mark.parametrize("start,stop,num", [(0.0, 1.0, 11), (-3.7, 2.9, 50),
                                            (1.0, 1e4, 7), (2.0, 5.0, 1),
                                            (0.1, 0.7, 2)])
def test_linspace_within_4_ulps(start, stop, num):
    got = n(tm.linspace(RES, start, stop, num))
    want = np.asarray(rm.linspace(None, start, stop, num))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got[0] == want[0] and got[-1] == want[-1]
    ulp = np.spacing(np.float32(max(abs(start), abs(stop))))
    assert (np.abs(got - want) <= 4 * ulp).all()


def test_sign_flip_exact_with_ties_zeros_and_nan():
    x = _ints_as_float((6, 5), seed=9)
    x[:, 1] = 0.0                        # all-zero column: sign +1
    x[2, 2], x[4, 2] = -9.0, 9.0         # |max| tie: the first (-) wins
    x[3, 3] = np.nan                     # NaN is the largest |v|
    _bits_equal(tm.sign_flip(RES, t(x)), rm.sign_flip(None, x))


@pytest.mark.parametrize("direction", [tm.SHIFT_TOWARDS_END,
                                       tm.SHIFT_TOWARDS_BEGINNING])
@pytest.mark.parametrize("k", [1, 3])
def test_shifts_exact(direction, k):
    x = _ints_as_float((5, 6))
    for fill_kw in (dict(fill_value=-1.0),
                    dict(values=np.arange(k, dtype=np.float32))):
        _same(tm.col_shift(RES, t(x), k, direction, **fill_kw),
              rm.col_shift(None, x, k, direction, **fill_kw))
    for fill_kw in (dict(fill_value=2.5),
                    dict(values=np.arange(6, dtype=np.float32))):
        _same(tm.row_shift(RES, t(x), k, direction, **fill_kw),
              rm.row_shift(None, x, k, direction, **fill_kw))
    assert tm.SHIFT_TOWARDS_END == rm.SHIFT_TOWARDS_END
    assert tm.SHIFT_TOWARDS_BEGINNING == rm.SHIFT_TOWARDS_BEGINNING


def _sort_rows_float():
    x = _rng(11).normal(size=(6, 9)).astype(np.float32)
    x[0] = [3.0, np.nan, -1.0, 3.0, np.nan, 0.0, -0.0, 2.0, -np.inf]
    x[1] = [0.0, -0.0, 0.0, -0.0, 1.0, -1.0, 1.0, -1.0, 0.0]   # ties
    x[2] = np.nan
    x[3, ::2] = np.inf
    x[4, :] = 1.25
    return x


def _sort_rows_int():
    imin, imax = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    x = _rng(12).integers(-5, 5, (4, 8)).astype(np.int32)
    x[0] = [imin, 3, imax, -1, imin, 0, imax, 3]
    x[1] = 2
    return x


@pytest.mark.parametrize("rows", ["float", "int"])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("return_indices", [False, True])
def test_sort_cols_per_row_exact(rows, ascending, return_indices):
    x = _sort_rows_float() if rows == "float" else _sort_rows_int()
    got = tm.sort_cols_per_row(RES, t(x), ascending, return_indices)
    want = rm.sort_cols_per_row(None, x, ascending, return_indices)
    if return_indices:
        _same(got[1], want[1])
        _bits_equal(got[0], want[0]) if rows == "float" else \
            _same(got[0], want[0])
    elif rows == "float":
        _bits_equal(got, want)
    else:
        _same(got, want)


def test_sample_rows_distinct_rows_of_the_input():
    x = np.arange(200 * 3, dtype=np.float32).reshape(200, 3)
    r_state, t_state = RState(3), TState(3)
    want = rm.sample_rows(None, r_state, x, 50)
    got = n(tm.sample_rows(RES, t_state, t(x), 50))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert t_state.base_subsequence == r_state.base_subsequence == 1
    rows = got[:, 0] / 3
    assert np.unique(rows).size == 50
    np.testing.assert_array_equal(got, x[rows.astype(int)])


def test_print_matrix_format(capsys):
    x = np.array([[1.0, 2.5, -3.0], [4e-7, 5e9, 0.0]], np.float32)
    want = rm.print_matrix(None, x, "m", ", ", ";\n")
    got = tm.print_matrix(RES, t(x), "m", ", ", ";\n")
    assert got == want
    assert tm.print_matrix(RES, t(x)) == rm.print_matrix(None, x)
    out = capsys.readouterr().out
    assert got in out


@pytest.mark.parametrize("along_lines", [True, False])
def test_linewise_op_exact(along_lines):
    x = _ints_as_float((5, 4))
    length = 4 if along_lines else 5
    v1 = _ints_as_float((length,), seed=2)
    v2 = np.abs(_ints_as_float((length,), seed=3)) + 1

    def op(m, a, b):
        return m * a + b

    _same(tm.linewise_op(RES, t(x), op, along_lines, t(v1), t(v2)),
          rm.linewise_op(None, x, op, along_lines, v1, v2))


def test_argminmax_shim_exact_with_ties_and_nan():
    x = _ints_as_float((6, 7), seed=4)
    x[1, [2, 5]] = -20.0
    x[2, [0, 6]] = 20.0
    x[3, 4] = np.nan
    for name in ("argmin", "argmax"):
        _same(getattr(targ, name)(RES, t(x)),
              getattr(rm, name)(None, x))
    xi = _rng(6).integers(-3, 3, (5, 8)).astype(np.int32)
    _same(targ.argmin(RES, t(xi)), rm.argmin(None, xi))
    _same(targ.argmax(RES, t(xi)), rm.argmax(None, xi))


def test_reference_spellings():
    for alias, name in (("col_wise_sort", "sort_cols_per_row"),
                        ("diagonal", "get_diagonal"), ("norm", "l2_norm"),
                        ("reverse", "row_reverse"), ("shift", "row_shift"),
                        ("threshold", "zero_small_values"),
                        ("triangular", "upper_triangular")):
        assert getattr(tm, alias) is getattr(tm, name)
        assert hasattr(rm, alias)
