"""The port's Borůvka MST (raft_tpu_torch/sparse/solver/mst.py) against
both routes of the reference's: its XLA round (the default here) and its
slot-grid Pallas round (forced with RAFT_TPU_MST=grid, interpreted).

Both reference routes and the port order edges by the same strict total
order, (weight, canonical undirected pair, CSR position), and emit the
forest in CSR-position order, so the comparison is exact: the forest's
src, dst and weights arrays element for element, and the final colors.
The forest's total weight is also held to scipy's in f64. The grid route
casts weights to f32, so f64 graphs are held to the XLA route only. On
the CPU the port runs the E-stage kernel's plain version.
"""

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse import csgraph

import raft_tpu_torch as rt
from _torch_util import n as host
from _torch_util import t as t_
from raft_tpu.core.sparse_types import CSRMatrix as JCSR
from raft_tpu.sparse.solver.mst import mst as j_mst
from raft_tpu_torch.core.sparse_types import CSRMatrix as TCSR
from raft_tpu_torch.sparse.solver import GraphCOO, mst as t_mst
from raft_tpu_torch.sparse.solver import mst_grid as tmg

CPU = rt.device_resources("cpu")


def _path(n=900, seed=4):
    rng = np.random.default_rng(seed)
    i = np.arange(n - 1)
    w = rng.uniform(1, 2, n - 1).astype(np.float32)
    return sp.csr_matrix((np.concatenate([w, w]),
                          (np.concatenate([i, i + 1]),
                           np.concatenate([i + 1, i]))), shape=(n, n))


def _star(n=600, seed=5):
    rng = np.random.default_rng(seed)
    s = np.zeros(n - 1, np.int64)
    t = np.arange(1, n)
    w = rng.uniform(1, 2, n - 1).astype(np.float32)
    return sp.csr_matrix((np.concatenate([w, w]),
                          (np.concatenate([s, t]), np.concatenate([t, s]))),
                         shape=(n, n))


def _equal_weights(n=200, seed=3):
    rng = np.random.default_rng(seed)
    d = (rng.uniform(size=(n, n)) < 0.05).astype(np.float32)
    a = sp.csr_matrix(np.maximum(d, d.T))
    a.setdiag(0)
    a.eliminate_zeros()
    return a


def _random_forest(n=250, seed=0, density=0.03):
    rng = np.random.default_rng(seed)
    d = np.abs(rng.normal(size=(n, n))).astype(np.float32) + 0.01
    d[rng.uniform(size=(n, n)) > density] = 0
    a = sp.csr_matrix(np.minimum(d, d.T))
    a.eliminate_zeros()
    return a


def _rounded_ties(n=300, seed=7):
    """Many exact ties among weights rounded to one decimal."""
    rng = np.random.RandomState(seed)
    dense = np.triu(np.round(rng.rand(n, n), 1), 1)
    dense = dense * (dense < 0.3)
    return (sp.coo_matrix(dense) + sp.coo_matrix(dense).T).tocsr().astype(
        np.float32)


def _two_cliques(n=40, seed=13):
    """Two disconnected cliques: a phantom pad edge of a bucketed CSR would
    bridge them."""
    half = n // 2
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, n), np.float32)
    for blk in (slice(0, half), slice(half, n)):
        w = rng.random((half, half)).astype(np.float32) + 0.5
        dense[blk, blk] = np.triu(w, 1)
    return sp.csr_matrix(dense + dense.T)


GRAPHS = {
    "path900": _path,
    "star600": _star,
    "equal_weights": _equal_weights,
    "forest_a": lambda: _random_forest(seed=0),
    "forest_b": lambda: _random_forest(seed=1, density=0.01),
    "components": lambda: _random_forest(n=150, seed=6, density=0.04),
    "rounded_ties": _rounded_ties,
    "two_cliques": _two_cliques,
}


def _run_both(a, *, pad, symmetrize):
    n = a.shape[0]
    jcol = np.arange(n, dtype=np.int32)
    tcol = jcol.copy()
    want = j_mst(None, JCSR.from_scipy(a, pad=pad), color=jcol,
                 symmetrize_output=symmetrize)
    got = t_mst(CPU, TCSR.from_scipy(a, pad=pad, res=CPU), color=tcol,
                symmetrize_output=symmetrize)
    return want, got, jcol, tcol


def _assert_same_forest(want, got, jcol, tcol):
    assert isinstance(got, GraphCOO) and got.n_edges == want.n_edges
    for field in ("src", "dst", "weights"):
        w, g = np.asarray(getattr(want, field)), host(getattr(got, field))
        assert g.shape == w.shape, field
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=field)
    np.testing.assert_array_equal(tcol, jcol)


def _assert_scipy_weight(a, got, symmetrize=True):
    """Total weight against scipy's MST in f64 (the forest's f32 weights
    summed in f64), and n - n_components undirected edges."""
    ref = csgraph.minimum_spanning_tree(a.astype(np.float64))
    total = host(got.weights).astype(np.float64).sum()
    if symmetrize:
        total /= 2
    np.testing.assert_allclose(total, ref.sum(), rtol=1e-12)
    n_comp = csgraph.connected_components(a, directed=False)[0]
    assert got.n_edges // (2 if symmetrize else 1) == a.shape[0] - n_comp


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_mst_matches_reference(graph):
    """Against the reference's default (XLA) route, on a bucketed CSR."""
    a = GRAPHS[graph]()
    want, got, jcol, tcol = _run_both(a, pad=True, symmetrize=True)
    _assert_same_forest(want, got, jcol, tcol)
    _assert_scipy_weight(a, got)


@pytest.mark.parametrize("graph", ["two_cliques", "forest_b"])
def test_mst_unpadded_matches_reference(graph):
    a = GRAPHS[graph]()
    want, got, jcol, tcol = _run_both(a, pad=False, symmetrize=True)
    _assert_same_forest(want, got, jcol, tcol)


@pytest.mark.parametrize("graph", ["path900", "star600", "equal_weights",
                                   "components", "two_cliques"])
def test_mst_matches_reference_grid_route(graph, monkeypatch):
    """Against the reference's slot-grid Pallas E-stage, interpreted."""
    monkeypatch.setenv("RAFT_TPU_MST", "grid")
    a = GRAPHS[graph]()
    want, got, jcol, tcol = _run_both(a, pad=True, symmetrize=False)
    _assert_same_forest(want, got, jcol, tcol)
    _assert_scipy_weight(a, got, symmetrize=False)


@pytest.mark.parametrize("graph", ["forest_a", "rounded_ties", "path900"])
def test_mst_f64_matches_reference(graph):
    """f64 weights stay f64 (the reference's XLA route under x64)."""
    a = GRAPHS[graph]().astype(np.float64)
    a.data += np.linspace(0, 1e-9, a.nnz)        # not representable in f32
    a = sp.csr_matrix(np.maximum(a.toarray(), a.toarray().T))
    want, got, jcol, tcol = _run_both(a, pad=True, symmetrize=True)
    assert str(got.weights.dtype) == "torch.float64"
    _assert_same_forest(want, got, jcol, tcol)


def test_mst_seeded_colors():
    """A coloring given by the caller seeds the rounds: vertices that
    share a color start merged."""
    a = _random_forest(n=120, seed=9, density=0.05)
    seed_col = (np.arange(120) // 3 * 3).astype(np.int32)
    jcol, tcol = seed_col.copy(), seed_col.copy()
    want = j_mst(None, JCSR.from_scipy(a), color=jcol)
    got = t_mst(CPU, TCSR.from_scipy(a, res=CPU), color=tcol)
    _assert_same_forest(want, got, jcol, tcol)


def test_per_vertex_min_edge_identity_and_order():
    """The E-stage alone: rows with no cross edge (isolated, or all
    neighbours of their color, or only a self-loop) give the identity;
    ties on weight go to the smaller canonical pair, then the smaller
    CSR position."""
    dense = np.zeros((6, 6), np.float32)
    for u, v, w in ((0, 1, 2.0), (0, 2, 2.0), (1, 2, 1.0), (3, 4, 5.0)):
        dense[u, v] = dense[v, u] = w
    dense[5, 5] = 0.5                               # self-loop only
    a = TCSR.from_scipy(sp.csr_matrix(dense), res=CPU)
    colors = np.array([0, 1, 2, 3, 3, 5], np.int32)
    w, key, eid = tmg.per_vertex_min_edge(a, colors)
    assert host(w).tolist() == [2.0, 1.0, 1.0, np.inf, np.inf, np.inf]
    assert host(key).tolist()[:3] == [0 * 6 + 1, 1 * 6 + 2, 1 * 6 + 2]
    assert host(key).tolist()[3:] == [tmg.KEY_MAX] * 3
    assert host(eid).tolist()[3:] == [tmg.EID_MAX] * 3


def _hub_graph(n=3000, hub=100_000, seed=8):
    """A CSR (numpy indptr, indices, data) with rows of 0-20 entries, a
    third empty, a hub row of ``hub`` entries and rows of exactly 256 and
    257 entries; 37 pad entries past indptr[-1]."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 21, n)
    lengths[rng.random(n) < 0.33] = 0
    lengths[5], lengths[6], lengths[11] = hub, 256, 257
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(lengths)
    nnz = int(indptr[-1])
    indices = rng.integers(0, n, nnz + 37).astype(np.int32)
    data = (rng.random(nnz + 37) + 1.0).astype(np.float32)
    return indptr, indices, data


@pytest.mark.parametrize("idx", [np.int32, np.int64])
def test_mst_plan_owners_recount(idx):
    """prepare_mst's split, made once per graph: csr_spmv's chunk owners
    over the physical entries (37 pads included) and its lanes a short row
    (held by tests/test_torch_sparse.py's split tests), on a graph with a
    100,000-entry hub row whose tail, recounted here, owns every chunk
    from its first boundary to the one holding its last entry."""
    from raft_tpu_torch.core.sparse_types import CSRMatrix as TC
    from raft_tpu_torch.sparse.grid_spmv import (SPMV_SEG, _spmv_lanes,
                                                 _spmv_owners)

    indptr, indices, data = _hub_graph()
    n_rows = indptr.shape[0] - 1
    plan = tmg.prepare_mst(TC(t_(indptr.astype(idx)), t_(indices),
                              t_(data), (n_rows, n_rows)))
    got = host(plan.owners)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, host(_spmv_owners(
        t_(indptr), indices.shape[0])))
    assert got.shape == (indices.shape[0] // SPMV_SEG + 1,)
    s, e = indptr[5], indptr[6]
    hub = np.flatnonzero(got == 5)
    assert hub.tolist() == list(range(-(-s // SPMV_SEG),
                                      (e - 1) // SPMV_SEG + 1))
    assert plan.lanes == _spmv_lanes(indices.shape[0], n_rows)
