"""The port's sparse layer (raft_tpu_torch.core.sparse_types, sparse.convert,
sparse.op, sparse.grid_spmv, sparse.linalg) against the reference's.

Structure is exact: the same scipy matrix gives the same ``indptr``,
``indices`` and ``data`` bits and dtypes in both packages, padding
included, and every conversion and structural op returns the reference's
arrays bit for bit. SpMV/SpMM run the port's plain versions (CPU
tensors) against the reference's slot-grid kernels (``grid_spmv.spmv`` /
``spmm`` on a prepared plan, Pallas interpreted on the CPU) and its
segment path (``sparse.linalg``); sums reassociate, so they agree to
|y − y_ref| <= 2e-5 · (|A|·|x|)_row + 2e-5, with the same NaN and inf
positions. Float sums of degrees (Laplacian diagonal, row sums) agree to
the same relative bound.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from _torch_util import n, t
from raft_tpu.core import sparse_types as jst
from raft_tpu.sparse import convert as jconv
from raft_tpu.sparse import grid_spmv as jgrid
from raft_tpu.sparse import linalg as jlin
from raft_tpu.sparse import op as jop
from raft_tpu_torch import interop, kernels
from raft_tpu_torch.core import sparse_types as tst
from raft_tpu_torch.sparse import convert as tconv
from raft_tpu_torch.sparse import grid_spmv as tgrid
from raft_tpu_torch.sparse import linalg as tlin
from raft_tpu_torch.sparse import op as top

REL = ATOL = 2e-5


def _random(rng, n_rows, n_cols, density):
    dense = rng.normal(size=(n_rows, n_cols)).astype(np.float32)
    dense[rng.uniform(size=(n_rows, n_cols)) > density] = 0.0
    return sp.csr_matrix(dense)


def _hub(rng, n=600):
    r = np.concatenate([np.full(400, 37), rng.integers(0, n, 2000),
                        np.full(300, 599)])
    c = np.concatenate([rng.integers(0, n, 400), np.full(2000, 11),
                        rng.integers(0, n, 300)])
    a = sp.csr_matrix((rng.normal(size=r.size).astype(np.float32), (r, c)),
                      shape=(n, n))
    a.sum_duplicates()
    return a


def _empty_rows(rng):
    a = _random(rng, 200, 200, 0.02).tolil()
    a[50:150] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    return a


def _tail_rows(rng, n=4000):
    r = np.sort(rng.choice(n, 60, replace=False))
    return sp.csr_matrix((rng.normal(size=60).astype(np.float32),
                          (r, rng.integers(0, n, 60))), shape=(n, n))


def _dense_row(rng, n=700):
    return sp.csr_matrix((rng.normal(size=n).astype(np.float32),
                          (np.zeros(n, np.int64), np.arange(n))),
                         shape=(4, n))


def _stored_zero():
    # [[2, 0], [3, 0]] with an explicit stored zero at (0, 1)
    return sp.csr_matrix((np.array([2.0, 0.0, 3.0], np.float32),
                          np.array([0, 1, 0]), np.array([0, 2, 3])),
                         shape=(2, 2))


# the shapes of tests/test_grid_spmv.py: (matrix, x, prepare kwargs)
CASES = {
    "random": lambda r: (_random(r, 500, 700, 0.05), None, {}),
    "multi_shard": lambda r: (_random(r, 300, 900, 0.04), None,
                              {"shard_w": 256}),
    "hub_rows_and_cols": lambda r: (_hub(r), None, {"shard_w": 256}),
    "sparse_tail_rows": lambda r: (_tail_rows(r), None, {"shard_w": 512}),
    "empty_rows": lambda r: (_empty_rows(r), None, {}),
    "empty_matrix": lambda r: (sp.csr_matrix((64, 64), dtype=np.float32),
                               np.ones(64, np.float32), {}),
    "single_dense_row": lambda r: (_dense_row(r), None, {"shard_w": 256}),
    "stored_zero_inf": lambda r: (_stored_zero(),
                                  np.array([1.0, np.inf], np.float32), {}),
    "inf_x_padding": lambda r: (_random(r, 100, 300, 0.05), None,
                                {"shard_w": 256, "inf_at": 7}),
}


def _case(name, seed=0):
    rng = np.random.default_rng(seed)
    a, x, kw = CASES[name](rng)
    kw = dict(kw)
    inf_at = kw.pop("inf_at", None)
    if x is None:
        x = rng.normal(size=a.shape[1]).astype(np.float32)
        if inf_at is not None:
            x[inf_at] = np.inf
    return a, x, kw


def _port_csr(jcsr) -> tst.CSRMatrix:
    return interop.csr_from_numpy(np.asarray(jcsr.indptr),
                                  np.asarray(jcsr.indices),
                                  np.asarray(jcsr.data), jcsr.shape,
                                  res=_cpu())


def assert_product_close(got, want, a, x):
    """The §3 tolerance, relative to each output's |A|·|x| mass; NaN and
    inf in the same places."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    with np.errstate(invalid="ignore"):
        mass = abs(a).astype(np.float64) @ np.abs(np.asarray(x, np.float64))
        err = np.abs(got - want)[fin]
    assert np.all(err <= REL * mass[fin] + ATOL), float(err.max())


# ---------------------------------------------------------------------------
# types and the padding contract
# ---------------------------------------------------------------------------


def _same(got: torch.Tensor, want):
    want = np.asarray(want)
    assert n(got).dtype == want.dtype, (n(got).dtype, want.dtype)
    np.testing.assert_array_equal(n(got), want)


@pytest.mark.parametrize("pad", [None, True, False])
@pytest.mark.parametrize("name", ["random", "hub_rows_and_cols",
                                  "empty_matrix", "sparse_tail_rows"])
def test_from_scipy_builds_the_reference_structure(name, pad):
    a, _, _ = _case(name)
    j = jst.CSRMatrix.from_scipy(a, pad=pad)
    c = tst.CSRMatrix.from_scipy(a, pad=pad, res=_cpu())
    _same(c.indptr, j.indptr)
    _same(c.indices, j.indices)
    _same(c.data, j.data)
    assert c.nnz == j.nnz and c.logical_nnz() == j.logical_nnz() == a.nnz
    assert c.shape == j.shape
    if pad is not False:
        assert c.nnz == tst.nnz_bucket(a.nnz) >= a.nnz
        assert not n(c.indices)[a.nnz:].any() and not n(c.data)[a.nnz:].any()
    d = c.depad()
    assert d.nnz == a.nnz and c.to_scipy().nnz == a.nnz
    assert (c.to_scipy() != a).nnz == 0
    for got, want in zip(c.host_edges(), j.host_edges()):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    _same(c.row_ids(), j.row_ids())
    _same(c.row_lengths(), j.row_lengths())


def _cpu():
    from raft_tpu_torch import device_resources

    return device_resources("cpu")


def test_sparse_pad_knob_and_size_classes(monkeypatch):
    for v in (0, 1, 255, 256, 257, 320, 321, 448, 449, 1000, 10 ** 6):
        assert tst.nnz_bucket(v) == jst.nnz_bucket(v)
        assert tst.nnz_bucket(v, 64) == jst.nnz_bucket(v, 64)
    a = _random(np.random.default_rng(1), 40, 30, 0.1)
    monkeypatch.setenv("RAFT_TPU_SPARSE_PAD", "0")
    c = tst.CSRMatrix.from_scipy(a, res=_cpu())
    assert c.nnz == a.nnz == jst.CSRMatrix.from_scipy(a).nnz
    monkeypatch.setenv("RAFT_TPU_SPARSE_PAD", "1")
    c = tst.CSRMatrix.from_scipy(a, res=_cpu())
    assert c.nnz == jst.CSRMatrix.from_scipy(a).nnz == 256
    p = c.pad_nnz(300)
    assert p.nnz == 300 and p.logical_nnz() == a.nnz
    assert p.pad_nnz(10) is p
    h = p.to_host()
    assert h.nnz == 300 and h.logical_nnz() == a.nnz


def test_coo_matrix_round_trips():
    a = _random(np.random.default_rng(2), 30, 20, 0.2).tocoo()
    j = jst.COOMatrix.from_scipy(a)
    c = tst.COOMatrix.from_scipy(a, res=_cpu())
    for got, want in ((c.rows, j.rows), (c.cols, j.cols), (c.data, j.data)):
        _same(got, want)
    assert c.nnz == j.nnz and c.shape == j.shape
    assert (c.to_scipy().tocsr() != a.tocsr()).nnz == 0
    assert c.to_host().nnz == c.nnz


# ---------------------------------------------------------------------------
# conversions and structural ops: exact
# ---------------------------------------------------------------------------


def _coo_pair(a, dup=False, seed=3):
    """The same COO in both packages; ``dup`` appends repeated entries
    (runs of 2 to 4) in shuffled order."""
    coo = a.tocoo()
    r, c, d = coo.row.astype(np.int32), coo.col.astype(np.int32), coo.data
    if dup and len(r):
        rng = np.random.default_rng(seed)
        pick = rng.integers(0, len(r), max(1, len(r) // 3))
        pick = np.concatenate([pick, pick[: len(pick) // 2]])
        r, c = np.concatenate([r, r[pick]]), np.concatenate([c, c[pick]])
        d = np.concatenate([d, rng.normal(size=len(pick)).astype(d.dtype)])
        perm = rng.permutation(len(r))
        r, c, d = r[perm], c[perm], d[perm]
    return (jst.COOMatrix(jnp.asarray(r), jnp.asarray(c), jnp.asarray(d),
                          a.shape),
            tst.COOMatrix(t(r), t(c), t(d), a.shape))


def _same_coo(got, want):
    for g, w in ((got.rows, want.rows), (got.cols, want.cols),
                 (got.data, want.data)):
        _same(g, w)
    assert got.shape == want.shape


def _same_csr(got, want):
    for g, w in ((got.indptr, want.indptr), (got.indices, want.indices),
                 (got.data, want.data)):
        _same(g, w)
    assert got.shape == want.shape


STRUCT_MATS = ["random", "hub_rows_and_cols", "empty_rows", "empty_matrix",
               "single_dense_row"]


@pytest.mark.parametrize("name", STRUCT_MATS)
def test_conversions_match_reference(name):
    a, _, _ = _case(name)
    j = jst.CSRMatrix.from_scipy(a)             # padded: pads must drop
    c = _port_csr(j)
    _same_coo(tconv.csr_to_coo(c), jconv.csr_to_coo(j))
    _same(tconv.csr_to_dense(c), jconv.csr_to_dense(j))
    dense = a.toarray()
    _same_csr(tconv.dense_to_csr(t(dense)), jconv.dense_to_csr(dense))
    _same_csr(tconv.dense_to_csr(t(dense), tol=0.5),
              jconv.dense_to_csr(dense, tol=0.5))
    _same_csr(tconv.adj_to_csr(t(dense != 0)), jconv.adj_to_csr(dense != 0))
    jcoo, tcoo = _coo_pair(a)
    _same_csr(tconv.sorted_coo_to_csr(top.coo_sort(tcoo)),
              jconv.sorted_coo_to_csr(jop.coo_sort(jcoo)))
    assert tconv.coo_to_csr is tconv.sorted_coo_to_csr
    lo, hi = a.shape[0] // 4, a.shape[0] // 2 + 1
    _same_csr(top.csr_row_slice(c, lo, hi), jop.csr_row_slice(j, lo, hi))
    got = top.csr_row_op(c, lambda rows, vals: vals * rows.to(vals.dtype))
    want = jop.csr_row_op(j, lambda rows, vals: vals * rows.astype(vals.dtype))
    _same(got, want)


def test_bitset_conversions_wait_for_core_bitset():
    with pytest.raises(NotImplementedError, match="item 12"):
        tconv.bitmap_to_csr(None)
    with pytest.raises(NotImplementedError, match="item 12"):
        tconv.bitset_to_csr(None, 3)


@pytest.mark.parametrize("reduce", ["sum", "max", "min", "prod"])
@pytest.mark.parametrize("name", ["random", "hub_rows_and_cols",
                                  "empty_matrix"])
def test_ops_match_reference(name, reduce):
    a, _, _ = _case(name)
    jcoo, tcoo = _coo_pair(a, dup=True)
    _same_coo(top.coo_sort(tcoo), jop.coo_sort(jcoo))
    np_fn = {"sum": np.add.reduceat, "max": np.maximum.reduceat,
             "min": np.minimum.reduceat,
             "prod": np.multiply.reduceat}[reduce]
    _same_coo(top.reduce_duplicates(tcoo, np_fn),
              jop.reduce_duplicates(jcoo, np_fn))
    _same_coo(top.max_duplicates(tcoo), jop.max_duplicates(jcoo))
    _same_coo(top.sum_duplicates(tcoo), jop.sum_duplicates(jcoo))
    # any other reduction runs on the host, as in the reference
    def host(d, s):
        return np.logical_or.reduceat(d != 0, s).astype(d.dtype)

    _same_coo(top.reduce_duplicates(tcoo, host),
              jop.reduce_duplicates(jcoo, host))
    jz, tz = _coo_pair(a.multiply(a > 0.3).tocsr())
    _same_coo(top.coo_remove_zeros(tz), jop.coo_remove_zeros(jz))
    if a.nnz:
        v = float(a.data[0])
        _same_coo(top.coo_remove_scalar(tcoo, v),
                  jop.coo_remove_scalar(jcoo, v))


@pytest.mark.parametrize("longest", [3, 8, 40])
def test_duplicate_runs_fold_in_numpys_order(longest):
    """Runs of 1..``longest`` equal keys: products equal numpy's
    ``multiply.reduceat`` bit for bit at every length, sums equal
    ``add.reduceat`` on runs shorter than 9 (numpy adds longer runs
    pairwise) and stay within f32 rounding of it past that; two calls
    give the same bits."""
    rng = np.random.default_rng(longest)
    lengths = rng.integers(1, longest + 1, 300)
    key = np.repeat(rng.permutation(10_000)[:300], lengths)
    d = rng.uniform(0.5, 1.5, key.size).astype(np.float32)
    perm = rng.permutation(key.size)
    r, c, d = (key[perm] // 100).astype(np.int32), \
        (key[perm] % 100).astype(np.int32), d[perm]
    coo = tst.COOMatrix(t(r), t(c), t(d), (100, 100))
    order = np.lexsort((c, r))
    starts = np.flatnonzero(np.diff(np.concatenate([[-1], key[perm][order]])))
    run = np.diff(np.append(starts, key.size))
    for fn, exact in ((np.multiply.reduceat, run > 0),
                      (np.add.reduceat, run < 9)):
        got = top.reduce_duplicates(coo, fn).data
        want = fn(d[order], starts)
        assert np.array_equal(n(got)[exact], want[exact])
        np.testing.assert_allclose(n(got), want, rtol=1e-6)
        assert torch.equal(got, top.reduce_duplicates(coo, fn).data)


@pytest.mark.parametrize("name", STRUCT_MATS + ["sparse_tail_rows"])
def test_linalg_structure_matches_reference(name):
    a, _, _ = _case(name)
    j = jst.CSRMatrix.from_scipy(a)
    c = _port_csr(j)
    _same_csr(tlin.transpose(c), jlin.transpose(j))
    b = _random(np.random.default_rng(9), *a.shape, 0.05)
    jb = jst.CSRMatrix.from_scipy(b)
    _same_csr(tlin.csr_add(c, _port_csr(jb)), jlin.csr_add(j, jb))
    jcoo, tcoo = _coo_pair(a)
    _same(tlin.coo_degree(tcoo), jlin.coo_degree(jcoo))
    assert tlin.degree is tlin.coo_degree
    for reduce in (np.add.reduceat, np.maximum.reduceat):
        _same_coo(tlin.coo_symmetrize(tcoo, reduce),
                  jlin.coo_symmetrize(jcoo, reduce))
    assert tlin.symmetrize is tlin.coo_symmetrize
    _same_csr(tlin.csr_row_normalize_max(c), jlin.csr_row_normalize_max(j))
    mass = np.asarray(abs(a).sum(1)).ravel()
    for got, want in ((tlin.rows_sum(c), jlin.rows_sum(j)),
                      (tlin.csr_row_norm(c, "l1"),
                       jlin.csr_row_norm(j, "l1"))):
        assert np.all(np.abs(n(got) - np.asarray(want)) <= REL * mass + ATOL)
    _same(tlin.csr_row_norm(c, "linf"), jlin.csr_row_norm(j, "linf"))
    np.testing.assert_allclose(n(tlin.csr_row_norm(c, "l2")),
                               np.asarray(jlin.csr_row_norm(j, "l2")),
                               rtol=REL, atol=ATOL)
    got = tlin.csr_row_normalize_l1(c)
    want = jlin.csr_row_normalize_l1(j)
    _same(got.indptr, want.indptr)
    np.testing.assert_allclose(n(got.data), np.asarray(want.data),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="norm_type"):
        tlin.csr_row_norm(c, "l3")


@pytest.mark.parametrize("name", ["hub_rows_and_cols", "empty_rows",
                                  "empty_matrix", "karate_like"])
def test_laplacians_match_reference(name):
    if name == "karate_like":
        rng = np.random.default_rng(5)
        w = (rng.uniform(size=(60, 60)) < 0.1) * rng.uniform(
            0.5, 2.0, size=(60, 60))
        np.fill_diagonal(w, 1.0)                 # self-loops are dropped
        a = sp.csr_matrix((w + w.T).astype(np.float32))
    else:
        a, _, _ = _case(name)
        a = (abs(a) + abs(a).T).tocsr()
    j = jst.CSRMatrix.from_scipy(a)
    c = _port_csr(j)
    deg_mass = np.asarray(abs(a).sum(1)).ravel()
    for fn in ("laplacian", "laplacian_normalized"):
        got, want = getattr(tlin, fn)(c), getattr(jlin, fn)(j)
        _same(got.indptr, want.indptr)
        _same(got.indices, want.indices)
        gd, wd = n(got.data), np.asarray(want.data)
        assert gd.dtype == wd.dtype
        rows = np.repeat(np.arange(a.shape[0]), np.diff(n(got.indptr)))
        off = n(got.indices) != rows
        if fn == "laplacian":
            np.testing.assert_array_equal(gd[off], wd[off])
            assert np.all(np.abs(gd - wd)[~off]
                          <= REL * deg_mass[rows[~off]] + ATOL)
        else:
            np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="square"):
        tlin.laplacian(_port_csr(jst.CSRMatrix.from_scipy(
            _random(np.random.default_rng(0), 4, 5, 0.5))))


def test_symmetrize_knn_graph_matches_reference():
    rng = np.random.default_rng(6)
    idx = rng.integers(0, 50, (50, 6)).astype(np.int32)
    dist = rng.uniform(0.1, 2.0, (50, 6)).astype(np.float32)
    _same_coo(tlin.symmetrize_knn_graph(t(idx), t(dist)),
              jlin.symmetrize_knn_graph(idx, dist))


# ---------------------------------------------------------------------------
# SpMV / SpMM: the kernels' plain versions against the reference's grid
# kernels (interpreted) and segment path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_spmv_matches_reference(name):
    a, x, kw = _case(name)
    j = jst.CSRMatrix.from_scipy(a)
    plan = jgrid.prepare(j, **kw)
    want_grid = np.asarray(jgrid.spmv(plan, jnp.asarray(x)))
    want_seg = np.asarray(jlin.spmv(j, jnp.asarray(x)))
    c = _port_csr(j)
    tplan = tgrid.prepare(c, **kw)
    assert tplan.nnz == plan.nnz == a.nnz and tplan.pad_ratio == 1.0
    kernels.reset_launch_counts()
    for got in (tgrid.spmv(tplan, t(x)), tlin.spmv(c, t(x)),
                tlin.spmv(tplan, t(x)), tplan.matvec(t(x))):
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert_product_close(n(got), want_grid, a, x)
        assert_product_close(n(got), want_seg, a, x)
    assert set(kernels.launch_counts().values()) == {0}
    if name == "stored_zero_inf":
        y = n(tlin.spmv(c, t(x)))
        assert np.isnan(y[0]) and y[1] == 3.0
    if name == "empty_matrix":
        np.testing.assert_array_equal(n(tlin.spmv(c, t(x))), np.zeros(64))


@pytest.mark.parametrize("name,k", [
    (name, k) for name in ("hub_rows_and_cols", "inf_x_padding")
    for k in (1, 2, 8, 9, 16)] + [("random", 9), ("empty_rows", 2)])
def test_spmm_matches_reference(name, k):
    a, _, kw = _case(name)
    rng = np.random.default_rng(17 + k)
    b = rng.normal(size=(a.shape[1], k)).astype(np.float32)
    if name == "inf_x_padding":
        b[7, 0] = np.inf
    j = jst.CSRMatrix.from_scipy(a)
    want_grid = np.asarray(jgrid.spmm(jgrid.prepare(j, **kw),
                                      jnp.asarray(b)))
    want_seg = np.asarray(jlin.spmm(j, jnp.asarray(b)))
    c = _port_csr(j)
    got = tlin.spmm(c, t(b))
    assert got.shape == (a.shape[0], k) and got.dtype == torch.float32
    assert_product_close(n(got), want_grid, a, b)
    assert_product_close(n(got), want_seg, a, b)
    assert_product_close(n(tgrid.spmm(tgrid.prepare(c), t(b))), want_grid,
                         a, b)


def _spmm_split(indptr, n_entries, seg_len):
    """csrc/csr_spmm.cu's split of the work, warp by warp: row warps take
    a row's first ``seg_len`` entries into C[row] (slot -1); chunk warp c
    takes the entries of [c seg_len, (c + 1) seg_len) at offset >=
    seg_len in the row holding entry c seg_len (found as the kernel's
    binary search finds it) into partial slot c. Returns (row, start, end,
    slot) of every warp that writes, and the kernel's chunk count."""
    n_rows = indptr.numel() - 1
    ip = indptr.long()
    s, e = ip[:-1], ip[1:]
    rows = torch.arange(n_rows)
    out = [(rows, s, torch.minimum(e, s + seg_len),
            torch.full((n_rows,), -1))]
    n_chunks = n_entries // seg_len + 1
    first = torch.arange(n_chunks) * seg_len
    live = first < ip[-1]
    first = first[live]
    r = torch.searchsorted(ip[:n_rows], first, right=True) - 1
    a = torch.maximum(first, s[r] + seg_len)
    z = torch.minimum(first + seg_len, e[r])
    w = a < z
    out.append((r[w], a[w], z[w], torch.arange(n_chunks)[live][w]))
    return [torch.cat(t) for t in zip(*out)], n_chunks


def _split_lengths(name, seg_len):
    rng = np.random.default_rng(23)
    if name == "all_empty":
        return np.zeros(40, np.int64)
    if name == "one_long_row":
        return np.array([7 * seg_len + 3])
    lengths = rng.integers(0, 30, 500)
    lengths[rng.uniform(size=500) < 0.3] = 0
    lengths[[3, 250]] = [20 * seg_len + 17, 3 * seg_len]   # hub, boundary
    lengths[[4, 499]] = [seg_len + 1, 2 * seg_len]
    return lengths


@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("name", ["hub_and_empty_rows", "all_empty",
                                  "one_long_row"])
def test_spmm_split_covers_each_entry_once(name, idx):
    """The work split of csr_spmm.cu, on the wrapper's chunk count (from
    the physical entry count, pads included): every row is written by
    exactly one row warp; every entry below indptr[-1] falls in exactly one
    warp's range, of its own row, and none past it (pad entries); no warp
    takes more than SPMM_SEG entries; partial slots are distinct and
    inside the buffer. Summing the ranges as the kernel does (C[row] from
    the row warp, then the partials in chunk order) matches the
    reference's SpMM."""
    seg_len = tgrid.SPMM_SEG
    lengths = _split_lengths(name, seg_len)
    n_rows, nnz, pad = lengths.size, int(lengths.sum()), 9
    indptr = torch.zeros(n_rows + 1, dtype=idx)
    indptr[1:] = torch.cumsum(torch.as_tensor(lengths), 0)
    (r, start, end, slot), n_chunks = _spmm_split(indptr, nnz + pad,
                                                  seg_len)
    assert torch.equal(torch.bincount(r[slot < 0], minlength=n_rows),
                       torch.ones(n_rows, dtype=torch.int64))
    assert bool(((end - start) <= seg_len).all())
    cover = torch.zeros(nnz + pad, dtype=torch.int64)
    owner = torch.full((nnz + pad,), -1, dtype=torch.int64)
    for row, a, b in zip(r.tolist(), start.tolist(), end.tolist()):
        cover[a:b] += 1
        owner[a:b] = row
    assert torch.equal(cover, torch.tensor([1] * nnz + [0] * pad))
    assert torch.equal(owner[:nnz], torch.repeat_interleave(
        torch.arange(n_rows), torch.as_tensor(lengths)))
    parts = slot[slot >= 0]
    assert parts.unique().numel() == parts.numel()
    assert bool((parts < n_chunks).all())
    # the fix-up's chunks of a long row [s, e): (s + seg_len) // seg_len
    # to (e - 1) // seg_len, exactly those that wrote for it
    ip = indptr.long()
    for row in np.flatnonzero(lengths > seg_len):
        s, e = int(ip[row]), int(ip[row + 1])
        want = list(range((s + seg_len) // seg_len, (e - 1) // seg_len + 1))
        assert sorted(slot[(r == int(row)) & (slot >= 0)].tolist()) == want

    rng = np.random.default_rng(29)
    cols = rng.integers(0, 50, nnz + pad).astype(np.int32)
    vals = rng.normal(size=nnz + pad).astype(np.float32)
    b = rng.normal(size=(50, 4)).astype(np.float32)
    prods = t(vals)[:, None] * t(b)[torch.as_tensor(cols).long()]
    got = torch.zeros(n_rows, 4)
    part = torch.zeros(n_chunks, 4)
    for row, a, e, sl in zip(r.tolist(), start.tolist(), end.tolist(),
                             slot.tolist()):
        if sl < 0:
            got[row] = prods[a:e].sum(0)
        else:
            part[sl] = prods[a:e].sum(0)
    order = torch.argsort(slot)
    for row, sl in zip(r[order].tolist(), slot[order].tolist()):
        if sl >= 0:
            got[row] += part[sl]
    a = sp.csr_matrix((vals[:nnz], cols[:nnz], indptr.numpy()),
                      shape=(n_rows, 50))
    want = np.asarray(jlin.spmm(jst.CSRMatrix.from_scipy(a),
                                jnp.asarray(b)))
    assert_product_close(n(got), want, a, b)


def _tree(lanes):
    """The kernels' fixed shuffle tree over the last dimension (a power of
    two): lane v adds lane v ^ off, off halving down to 1; lane 0's sum."""
    while lanes.shape[-1] > 1:
        half = lanes.shape[-1] // 2
        lanes = lanes[..., :half] + lanes[..., half:]
    return lanes[..., 0]


def _lane_sums(prods, start, end, first, stride):
    """Each of ``stride`` lanes sums, in order, entries first + lane,
    first + lane + stride, ... below end (entries >= start only)."""
    out = torch.zeros(stride, dtype=prods.dtype)
    for lane in range(stride):
        for j in range(first + lane, end, stride):
            if j >= start:
                out[lane] += prods[j]
    return out


def _spmv_emulated(indptr, prods, n_entries, lpe, seg_len):
    """csrc/csr_spmv.cu's work split and sum order, from the products
    data[j] * x[indices[j]]. Row groups: lpe lanes take a short row (at
    most seg_len entries) or a long row's head (up to the first chunk
    boundary at or after its start), lane v every lpe-th entry from v,
    added by the tree. Chunk warps: chunk c takes the entries in [c
    seg_len, (c + 1) seg_len) of the long row the plan's owners name
    (grid_spmv._spmv_owners), a lane every 32nd, by the tree into partial
    c; the fix-up adds a long row's partials to y in chunk order. Returns
    y, how often each entry was summed, and the owners."""
    n_rows = indptr.numel() - 1
    ip = indptr.long()
    y = torch.zeros(n_rows, dtype=prods.dtype)
    seen = torch.zeros(n_entries, dtype=torch.int64)
    for r in range(n_rows):
        s, e = int(ip[r]), int(ip[r + 1])
        if e - s > seg_len:
            e = -(-s // seg_len) * seg_len
        assert e - s <= seg_len
        y[r] = _tree(_lane_sums(prods, s, e, s, lpe))
        seen[s:e] += 1
    owners = tgrid._spmv_owners(indptr, n_entries)
    part = torch.zeros(owners.numel(), dtype=prods.dtype)
    for c, r in enumerate(owners.tolist()):
        if r < 0:
            continue
        a, z = c * seg_len, min((c + 1) * seg_len, int(ip[r + 1]))
        assert a < z
        part[c] = _tree(_lane_sums(prods, a, z, a, 32))
        seen[a:z] += 1
    for r in range(n_rows):
        s, e = int(ip[r]), int(ip[r + 1])
        if e - s > seg_len:
            for c in range(-(-s // seg_len), (e - 1) // seg_len + 1):
                assert int(owners[c]) == r
                y[r] += part[c]
    return y, seen, owners


@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("name", ["hub_and_empty_rows", "all_empty",
                                  "one_long_row"])
def test_spmv_split_emulated(name, idx):
    """csr_spmv.cu's split at the wrapper's chunk count (physical entries,
    pads included), lanes (from the mean row length) and chunk owners (the
    plan's, computed on indptr's device without a host sync): every entry
    below indptr[-1] is summed exactly once and no pad entry at all; a hub
    row spreads over many chunk warps; the result, summed in the kernel's
    order, matches the reference's SpMV, and int32 and int64 indptr give
    the same owners."""
    seg_len = tgrid.SPMV_SEG
    lengths = _split_lengths(name, seg_len)
    n_rows, nnz, pad = lengths.size, int(lengths.sum()), 9
    indptr = torch.zeros(n_rows + 1, dtype=idx)
    indptr[1:] = torch.cumsum(torch.as_tensor(lengths), 0)
    rng = np.random.default_rng(31)
    cols = rng.integers(0, 50, nnz + pad).astype(np.int32)
    vals = rng.normal(size=nnz + pad).astype(np.float32)
    x = rng.normal(size=50).astype(np.float32)
    prods = t(vals) * t(x)[torch.as_tensor(cols).long()]
    lpe = tgrid._spmv_lanes(nnz + pad, n_rows)
    assert 1 <= lpe <= 32 and lpe & (lpe - 1) == 0
    got, seen, owners = _spmv_emulated(indptr, prods, nnz + pad, lpe,
                                       seg_len)
    assert torch.equal(seen, torch.tensor([1] * nnz + [0] * pad))
    assert owners.dtype == torch.int32 and torch.equal(
        owners, tgrid._spmv_owners(indptr.to(torch.int64 if idx ==
                                             torch.int32 else torch.int32),
                                   nnz + pad))
    if name == "hub_and_empty_rows":
        assert lengths.max() > 20 * seg_len
        assert int((owners == 3).sum()) >= 20
    a = sp.csr_matrix((vals[:nnz], cols[:nnz], indptr.numpy()),
                      shape=(n_rows, 50))
    want = np.asarray(jlin.spmv(jst.CSRMatrix.from_scipy(a), jnp.asarray(x)))
    assert_product_close(n(got), want, a, x)
    assert bool((got[torch.as_tensor(lengths) == 0] == 0).all())


@pytest.mark.parametrize("mean,lanes", [(0.0, 1), (8.0, 1), (18.2, 4),
                                        (33.0, 8), (1e4, 32)])
def test_spmv_lanes_follow_the_mean_row(mean, lanes):
    rows = 1000
    assert tgrid._spmv_lanes(int(mean * rows), rows) == lanes


def test_spmm_alpha_beta_and_plan_arguments():
    a, _, _ = _case("random")
    rng = np.random.default_rng(4)
    b = rng.normal(size=(a.shape[1], 3)).astype(np.float32)
    c0 = rng.normal(size=(a.shape[0], 3)).astype(np.float32)
    j = jst.CSRMatrix.from_scipy(a)
    want = np.asarray(jlin.spmm(j, jnp.asarray(b), alpha=0.5, beta=2.0,
                                c=jnp.asarray(c0)))
    got = n(tlin.spmm(_port_csr(j), t(b), alpha=0.5, beta=2.0, c=t(c0)))
    mass = 0.5 * abs(a) @ abs(b) + 2.0 * abs(c0)
    assert np.all(np.abs(got - want) <= REL * mass + ATOL)
    assert tlin.spmv_method(_port_csr(j)) == "grid"
    c = _port_csr(j)
    assert tlin._cached_plan(c) is tlin._cached_plan(c)
    with pytest.raises(ValueError, match="shard_w"):
        tgrid.prepare(c, shard_w=100)
    with pytest.raises(ValueError, match="span_windows"):
        tgrid.prepare(c, span_windows=0)
    with pytest.raises(ValueError, match="x must be"):
        tlin.spmv(c, torch.ones(3))
    with pytest.raises(NotImplementedError, match="guard_mode"):
        tlin.spmv(c, torch.ones(a.shape[1]), guard_mode="check")
    with pytest.raises(TypeError):
        tlin.spmv(jst.COOMatrix(None, None, None, (1, 1)), torch.ones(1))


def test_spmv_f64_stays_f64_like_the_segment_path():
    """Under jax_enable_x64 the reference's segment path keeps f64
    operands in f64; the port's products follow (f64 kernel on CUDA)."""
    a, x, _ = _case("random")
    a64 = a.astype(np.float64)
    x64 = x.astype(np.float64)
    j = jst.CSRMatrix.from_scipy(a64)
    want = np.asarray(jlin.spmv(j, jnp.asarray(x64)))
    assert want.dtype == np.float64
    got = tlin.spmv(_port_csr(j), t(x64))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(n(got), want, rtol=1e-12, atol=1e-12)
    # f32 matrix with an f64 x promotes too
    got = tlin.spmv(_port_csr(jst.CSRMatrix.from_scipy(a)), t(x64))
    assert got.dtype == torch.float64
    b = np.stack([x64, 2 * x64], 1)
    got = tlin.spmm(_port_csr(j), t(b))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(n(got), a64 @ b, rtol=1e-12, atol=1e-12)
