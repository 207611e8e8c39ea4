"""The port's pairwise_distance and fused_l2_nn_argmin
(raft_tpu_torch/distance/pairwise.py) against the reference package's:
the five expanded metrics at two tiers, and the metrics the first slice
left raising (all metrics are held to the reference in
tests/test_torch_unexpanded.py too).

Tolerance: at 'high' and 'highest' both packages form the same products
and differ only in f32 accumulation order, so distances agree to 1e-5
of the metric's magnitude (|x|² + |y|² for L2, 1 for the cosine family,
|x||y| for the inner product; its root for L2Sqrt). The self-distance
diagonal is exactly zero in both.
"""

import numpy as np
import pytest
import torch

from _torch_util import assert_labels_agree, both_tiers, exact_l2, n, \
    sq_norms, t
from raft_tpu.distance import DistanceType as JDT
from raft_tpu.distance import fused_l2_nn_argmin as j_nn
from raft_tpu.distance import pairwise_distance as j_pd
from raft_tpu_torch.distance import DistanceType as TDT
from raft_tpu_torch.distance import fused_l2_nn_argmin as t_nn
from raft_tpu_torch.distance import pairwise_distance as t_pd

REL = 1e-5
PORTED = ("L2Expanded", "L2SqrtExpanded", "CosineExpanded",
          "CorrelationExpanded", "InnerProduct")


def _data(seed, m=120, nn=50, k=17):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((nn, k)).astype(np.float32))


def _scale(name, x, y):
    xn, yn = sq_norms(x), sq_norms(y)
    if name == "L2Expanded":
        return xn[:, None] + yn[None, :]
    if name == "L2SqrtExpanded":
        return np.sqrt(xn[:, None] + yn[None, :])
    if name == "InnerProduct":
        return np.sqrt(np.outer(xn, yn))
    return np.ones((len(x), len(y)))


def test_distance_type_menu_matches_reference():
    assert [(e.name, e.value) for e in TDT] == \
        [(e.name, e.value) for e in JDT]


@pytest.mark.parametrize("tier", ["high", "highest"])
@pytest.mark.parametrize("name", PORTED)
@pytest.mark.parametrize("self_dist", [False, True])
def test_pairwise_distance_matches_reference(tier, name, self_dist):
    x, y = _data(1)
    yy = None if self_dist else y
    with both_tiers(tier):
        want = n(j_pd(None, x, yy, metric=JDT[name]))
        got = n(t_pd(None, t(x), None if self_dist else t(y),
                     metric=TDT[name]))
    assert got.shape == want.shape and got.dtype == np.float32
    scale = _scale(name, x, x if self_dist else y)
    tol = np.sqrt(REL) * scale if name == "L2SqrtExpanded" else REL * scale
    np.testing.assert_array_less(np.abs(got - want), tol + 1e-6)
    if self_dist and name != "InnerProduct":
        assert (np.diag(got) == 0).all()


def test_l2_expanded_sqrt_flag():
    x, y = _data(2)
    with both_tiers("high"):
        a = t_pd(None, t(x), t(y), metric=TDT.L2Expanded, sqrt=True)
        b = t_pd(None, t(x), t(y), metric=TDT.L2SqrtExpanded)
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["L1", "Linf", "Canberra", "LpUnexpanded",
                                  "HammingUnexpanded", "L2Unexpanded",
                                  "JaccardExpanded", "KLDivergence",
                                  "Haversine", "BrayCurtis"])
def test_unported_metrics_raise(name):
    """These ten raised NotImplementedError until the unexpanded tile and
    the plain-torch metrics were ported; now none raises, and each
    matches the reference on the same small inputs (4 x 3, k = 2; |x| for
    KL). Tolerance: f32 sums of two terms in another order, 1e-5 of the
    value, plus 1e-6."""
    x, y = _data(3, m=4, nn=3, k=2)
    if name == "KLDivergence":
        x, y = np.abs(x) + 0.1, np.abs(y) + 0.1
    want = np.asarray(j_pd(None, x, y, metric=JDT[name], p=3.0))
    got = n(t_pd(None, t(x), t(y), metric=TDT[name], p=3.0))
    assert got.shape == want.shape == (4, 3)
    np.testing.assert_allclose(got, want, rtol=REL, atol=1e-6)


def test_guard_modes_other_than_off_raise():
    x, y = _data(4, m=4, nn=3, k=2)
    assert t_pd(None, t(x), t(y), guard_mode="off").shape == (4, 3)
    with pytest.raises(NotImplementedError, match="guard_mode"):
        t_pd(None, t(x), t(y), guard_mode="check")


@pytest.mark.parametrize("sqrt", [False, True])
def test_fused_l2_nn_argmin_matches_reference(sqrt):
    x, y = _data(5, m=257, nn=31, k=19)
    with both_tiers("high"):
        jv, ji = j_nn(None, x, y, sqrt=sqrt)
        tv, ti = t_nn(None, t(x), t(y), sqrt=sqrt)
    scale = (sq_norms(x)[:, None] + sq_norms(y)[None, :]).max(1)
    assert_labels_agree(n(ti), n(ji), exact_l2(x, y), scale)
    tol = np.sqrt(REL * scale) if sqrt else REL * scale
    np.testing.assert_array_less(np.abs(n(tv) - n(jv)), tol + 1e-6)
