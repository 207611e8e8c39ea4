"""The port's label utilities (raft_tpu_torch.label) against the
reference package on the same numpy inputs, CPU tensors on the port's
side. Every comparison is exact.

``merge_labels`` is also held against ``scipy.sparse.csgraph``: every
point takes the smallest label of its component in the graph on the
labels whose edges are the masked pairs (a_i, b_i). Its inputs: random
labelings under random masks, unlabelled points (``MAX_LABEL``, which
pass through), and a chain of 24 labels that takes 24 rounds to settle.
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import connected_components

from _torch_util import n, t
from raft_tpu import label as rl
from raft_tpu_torch import label as tl
from raft_tpu_torch.core import trace

# the module (the package's attribute of that name is the function)
tmerge = importlib.import_module("raft_tpu_torch.label.merge_labels")

# A chain over the labels 1..24, edges between neighbours in this order.
# Found by a local search for the order whose fixed point takes the most
# rounds: the smallest label at one end, the next at the other, so the
# path halving cannot shortcut the walk of label 1 along the chain.
CHAIN = [1, 11, 6, 5, 13, 16, 14, 4, 23, 7, 18, 20, 10, 22, 19, 8, 24, 3,
         21, 9, 15, 12, 17, 2]


def _same(got, want):
    g, w = n(got), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_classlabels_exact(dtype):
    y = np.random.default_rng(1).choice([-4, 0, 3, 7, 11, 250], 60).astype(
        dtype)
    _same(tl.get_unique_labels(t(y)), rl.get_unique_labels(y))
    u = np.unique(y)
    for idx in range(u.size):
        _same(tl.get_ovr_labels(t(y), t(u), idx),
              rl.get_ovr_labels(y, u, idx))
    with pytest.raises(ValueError):
        tl.get_ovr_labels(t(y), t(u), u.size)
    for zero_based in (False, True):
        _same(tl.make_monotonic(t(y), zero_based=zero_based),
              rl.make_monotonic(y, zero_based=zero_based))
        _same(tl.make_monotonic(t(y), filter_op=lambda v: v < 0,
                                zero_based=zero_based),
              rl.make_monotonic(y, filter_op=lambda v: v < 0,
                                zero_based=zero_based))


def _component_min(a, b, mask, n_labels):
    """Expected merge: each point's smallest label in its component."""
    g = sp.coo_matrix((np.ones(mask.sum()), (a[mask], b[mask])),
                      shape=(n_labels + 1, n_labels + 1))
    _, comp = connected_components(g, directed=False)
    lo = np.full(comp.max() + 1, n_labels + 1)
    np.minimum.at(lo, comp, np.arange(n_labels + 1))
    out = lo[comp[np.where(a == tl.MAX_LABEL, 0, a)]]
    return np.where(a == tl.MAX_LABEL, a, out).astype(a.dtype)


@pytest.mark.parametrize("seed,n_pts,n_lab,p_mask", [
    (0, 200, 20, 1.0), (1, 200, 20, 0.05), (2, 500, 150, 0.3),
    (3, 64, 64, 0.9)])
def test_merge_labels_random_exact(seed, n_pts, n_lab, p_mask):
    rng = np.random.default_rng(seed)
    a = rng.integers(1, n_lab + 1, n_pts).astype(np.int32)
    b = rng.integers(1, n_lab + 1, n_pts).astype(np.int32)
    mask = rng.random(n_pts) < p_mask
    want = rl.merge_labels(a, b, mask)
    got = tl.merge_labels(t(a), t(b), t(mask))
    _same(got, want)
    np.testing.assert_array_equal(n(got), _component_min(a, b, mask, n_pts))


def test_merge_labels_unlabelled_points_pass_through():
    rng = np.random.default_rng(7)
    a = rng.integers(1, 30, 100).astype(np.int32)
    b = rng.integers(1, 30, 100).astype(np.int32)
    mask = rng.random(100) < 0.5
    a[[3, 40, 77]] = tl.MAX_LABEL
    mask[[3, 40, 77]] = False
    assert tl.MAX_LABEL == rl.MAX_LABEL
    want = rl.merge_labels(a, b, mask)
    got = tl.merge_labels(t(a), t(b), t(mask))
    _same(got, want)
    assert (n(got)[[3, 40, 77]] == tl.MAX_LABEL).all()
    np.testing.assert_array_equal(n(got), _component_min(a, b, mask, 100))
    bad = mask.copy()
    bad[3] = True                        # a masked unlabelled point
    with pytest.raises(ValueError):
        tl.merge_labels(t(a), t(b), t(bad))


def test_merge_labels_chain_takes_every_round():
    """The chain settles in 23 rounds after the first, within the cap
    of ``len(CHAIN) + 2``, and the call's event counts all 24; cut
    short, it leaves labels above 1."""
    k = len(CHAIN)
    a = np.array(CHAIN, np.int32)
    b = np.roll(a, -1)
    b[-1] = a[-1]
    mask = np.ones(k, bool)
    want = rl.merge_labels(a, b, mask)
    trace.clear_events()
    got = tl.merge_labels(t(a), t(b), t(mask))
    _same(got, want)
    assert (n(got) == 1).all()
    (event,) = trace.events("label.merge_labels")
    assert event["rows"] == k and event["rounds"] == k
    _, rounds = tmerge._merge_fixpoint(t(a).long(), t(b).long(),
                                       t(mask), k + 2)
    assert rounds == k - 1
    r_short, _ = tmerge._merge_fixpoint(t(a).long(), t(b).long(),
                                        t(mask), k - 3)
    assert (r_short[1:] > 1).any()
