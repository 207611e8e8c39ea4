"""Pairwise distances over the contraction engine (counterpart of
``raft_tpu/distance/pairwise.py``).

The expanded metrics (``L2Expanded``, ``L2SqrtExpanded``,
``CosineExpanded``, ``CorrelationExpanded``, ``InnerProduct``) ride the
pairwise tile kernel (``csrc/pairwise_tile.cu``); the 1-NN reduction
rides the fused argmin kernel (``csrc/fused_argmin.cu``). The other
metrics of :class:`DistanceType` are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch

from raft_tpu_torch.core.guards import resolve_guard_mode
from raft_tpu_torch.linalg.contractions import (fused_l2_argmin_pallas,
                                                pairwise_l2_pallas,
                                                pairwise_pallas)
from raft_tpu_torch.util.precision import with_matmul_precision


class DistanceType(enum.Enum):
    """Metric vocabulary, with the reference package's names and values."""

    L2Expanded = "l2_expanded"
    L2SqrtExpanded = "l2_sqrt_expanded"
    L2Unexpanded = "l2_unexpanded"
    L2SqrtUnexpanded = "l2_sqrt_unexpanded"
    L1 = "l1"
    Linf = "linf"
    Canberra = "canberra"
    LpUnexpanded = "lp_unexpanded"
    CosineExpanded = "cosine"
    CorrelationExpanded = "correlation"
    InnerProduct = "inner_product"
    HammingUnexpanded = "hamming"
    JaccardExpanded = "jaccard"
    HellingerExpanded = "hellinger"
    JensenShannon = "jensen_shannon"
    KLDivergence = "kl_divergence"
    RusselRaoExpanded = "russelrao"
    DiceExpanded = "dice"
    Haversine = "haversine"
    BrayCurtis = "braycurtis"


# Metrics of the unexpanded Pallas tile (raft_tpu contractions.py:525),
# still to be ported (ROADMAP.md queue B item 4).
_UNEXPANDED = {DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded,
               DistanceType.L1, DistanceType.Linf, DistanceType.Canberra,
               DistanceType.LpUnexpanded, DistanceType.HammingUnexpanded}


def _as2d(a) -> torch.Tensor:
    a = torch.as_tensor(a)
    return a[None, :] if a.ndim == 1 else a


def _dispatch_metric(x, y, metric: DistanceType,
                     sqrt: Optional[bool]) -> torch.Tensor:
    if metric == DistanceType.L2Expanded:
        return pairwise_l2_pallas(x, y, sqrt=bool(sqrt))
    if metric == DistanceType.L2SqrtExpanded:
        return pairwise_l2_pallas(x, y, sqrt=True)
    if metric == DistanceType.CosineExpanded:
        return pairwise_pallas(x, y, "cosine")
    if metric == DistanceType.CorrelationExpanded:
        x = x.to(torch.float32)
        y = y.to(torch.float32)
        return pairwise_pallas(x - x.mean(dim=1, keepdim=True),
                               y - y.mean(dim=1, keepdim=True), "cosine")
    if metric == DistanceType.InnerProduct:
        # the 'inner' tile is the negated product (a distance for argmin)
        return -pairwise_pallas(x, y, "inner")
    if metric in _UNEXPANDED:
        raise NotImplementedError(
            f"{metric.name}: the unexpanded-metric kernel is not ported yet "
            "(ROADMAP.md queue B item 4, _unexpanded_tile_kernel)")
    raise NotImplementedError(
        f"{metric.name}: not ported yet (ROADMAP.md queue A item 4, "
        "distance: the remaining metrics)")


@with_matmul_precision
def pairwise_distance(res, x, y=None,
                      metric: DistanceType = DistanceType.L2Expanded,
                      p: float = 2.0, sqrt: Optional[bool] = None,
                      guard_mode: Optional[str] = None) -> torch.Tensor:
    """Full m x n distance matrix between rows of x [m, k] and y [n, k];
    ``y=None`` means y = x, and then the diagonal is exactly zero for
    every true metric (not for ``InnerProduct``). ``res`` is accepted
    for API parity; the tensors' device decides where it runs. ``p``
    (Minkowski) belongs to a metric not ported yet."""
    resolve_guard_mode(guard_mode, "distance.pairwise_distance")
    x = _as2d(x)
    self_dist = y is None
    y = x if self_dist else _as2d(y)
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"feature dims differ: {x.shape[1]} vs {y.shape[1]}")
    d = _dispatch_metric(x, y, metric, sqrt)
    if self_dist and metric not in (DistanceType.InnerProduct,
                                    DistanceType.RusselRaoExpanded):
        d.fill_diagonal_(0.0)
    return d


@with_matmul_precision
def fused_l2_nn_argmin(res, x, y, sqrt: bool = False):
    """1-NN under L2 without materialising distances: ``(min_dist [m],
    argmin [m])``. CUDA kernel: ``csrc/fused_argmin.cu``."""
    val, idx = fused_l2_argmin_pallas(_as2d(x), _as2d(y))
    return (torch.sqrt(val) if sqrt else val), idx
