"""Pairwise distances over the contraction engine (counterpart of
``raft_tpu/distance/pairwise.py``), for every metric of
:class:`DistanceType`.

- The expanded metrics (``L2Expanded``, ``L2SqrtExpanded``,
  ``CosineExpanded``, ``CorrelationExpanded``, ``InnerProduct``) ride the
  pairwise tile kernel (``csrc/pairwise_tile.cu``); the 1-NN reduction
  rides the fused argmin kernel (``csrc/fused_argmin.cu``).
- The unexpanded metrics (``L2Unexpanded``, ``L2SqrtUnexpanded``, ``L1``,
  ``Linf``, ``Canberra``, ``LpUnexpanded``, ``HammingUnexpanded``) ride
  the unexpanded tile kernel (``csrc/unexpanded_tile.cu``), in f64 where
  an operand is f64.
- The rest (``JaccardExpanded``, ``HellingerExpanded``,
  ``JensenShannon``, ``KLDivergence``, ``RusselRaoExpanded``,
  ``DiceExpanded``, ``Haversine``, ``BrayCurtis``) are plain torch on the
  device, as the reference leaves them to XLA; the broadcast ones run in
  blocks of 1024 rows of x to bound the ``[rows, n, k]`` intermediate.

Not ported: guard modes other than ``off`` and the ``runtime.limits``
row tiling (ROADMAP.md queue A item 13b).
"""

from __future__ import annotations

import enum
from typing import Optional

import torch

from raft_tpu_torch.core.guards import resolve_guard_mode
from raft_tpu_torch.core.operators import exact_sqrt
from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.linalg.contractions import (fused_l2_argmin_pallas,
                                                pairwise_l2_pallas,
                                                pairwise_pallas,
                                                pairwise_unexpanded_pallas)
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


_EPS = 1e-8


def _as2d(a, res) -> torch.Tensor:
    a = as_tensor(a, res)
    return a[None, :] if a.ndim == 1 else a


def _floating(a: torch.Tensor) -> torch.Tensor:
    return a if a.is_floating_point() else a.to(torch.float32)


def _blocked_rowwise(x, y, row_fn, block: int = 4096):
    """``row_fn(x_block [bm, k], y [n, k]) -> [bm, n]`` over row blocks of
    x, bounding the broadcast ``[bm, n, k]`` intermediate."""
    if x.shape[0] <= block:
        return row_fn(x, y)
    return torch.cat([row_fn(x[i:i + block], y)
                      for i in range(0, x.shape[0], block)])


def _hellinger(x, y):
    s = exact_sqrt(torch.clamp_min(x, 0.0)) @ exact_sqrt(
        torch.clamp_min(y, 0.0)).T
    return exact_sqrt(torch.clamp_min(1.0 - s, 0.0))


def _kl(x, y):
    def f(xb, yy):
        a = xb[:, None, :]
        live = a > _EPS
        ratio = torch.where(live, a / torch.clamp_min(yy[None, :, :], _EPS),
                            1.0)
        term = a * torch.log(torch.clamp_min(ratio, _EPS))
        return torch.sum(torch.where(live, term, 0.0), dim=-1)
    return _blocked_rowwise(x, y, f, block=1024)


def _jensen_shannon(x, y):
    def f(xb, yy):
        p, q = xb[:, None, :], yy[None, :, :]
        mid = torch.clamp_min(0.5 * (p + q), _EPS)

        def kl_term(a):
            return torch.sum(torch.where(a > _EPS, a * torch.log(a / mid),
                                         0.0), dim=-1)
        return exact_sqrt(torch.clamp_min(0.5 * (kl_term(p) + kl_term(q)),
                                          0.0))
    return _blocked_rowwise(x, y, f, block=1024)


def _bool_stats(x, y):
    """Pair counts of boolean metrics by a product of 0/1 floats."""
    xf = (x != 0).to(torch.float32)
    yf = (y != 0).to(torch.float32)
    both = xf @ yf.T
    x_only = torch.sum(xf, dim=1, keepdim=True) - both
    y_only = torch.sum(yf, dim=1, keepdim=True).T - both
    return both, x_only, y_only, xf.shape[1]


def _haversine(x, y):
    if x.shape[1] != 2:
        raise ValueError("haversine needs [lat, lon] pairs (k == 2)")
    lat1, lon1 = x[:, None, 0], x[:, None, 1]
    lat2, lon2 = y[None, :, 0], y[None, :, 1]
    a = (torch.sin((lat2 - lat1) / 2) ** 2
         + torch.cos(lat1) * torch.cos(lat2)
         * torch.sin((lon2 - lon1) / 2) ** 2)
    return 2.0 * torch.arcsin(exact_sqrt(torch.clamp(a, 0.0, 1.0)))


def _braycurtis(x, y):
    def f(xb, yy):
        num = torch.sum((xb[:, None, :] - yy[None, :, :]).abs(), dim=-1)
        den = torch.sum((xb[:, None, :] + yy[None, :, :]).abs(), dim=-1)
        return torch.where(den > 0, num / torch.clamp_min(den, _EPS), 0.0)
    return _blocked_rowwise(x, y, f, block=1024)


def _dispatch_metric(x, y, metric: DistanceType, p: float,
                     sqrt: Optional[bool]) -> torch.Tensor:
    m = metric
    if m == DistanceType.L2Expanded:
        return pairwise_l2_pallas(x, y, sqrt=bool(sqrt))
    if m == DistanceType.L2SqrtExpanded:
        return pairwise_l2_pallas(x, y, sqrt=True)
    if m in (DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded):
        d = pairwise_unexpanded_pallas(x, y, "l2un")
        return exact_sqrt(d) if (sqrt or m == DistanceType.L2SqrtUnexpanded) \
            else d
    if m == DistanceType.L1:
        return pairwise_unexpanded_pallas(x, y, "l1")
    if m == DistanceType.Linf:
        return pairwise_unexpanded_pallas(x, y, "linf")
    if m == DistanceType.Canberra:
        return pairwise_unexpanded_pallas(x, y, "canberra")
    if m == DistanceType.LpUnexpanded:
        return pairwise_unexpanded_pallas(x, y, "lp", p) ** (1.0 / p)
    if m == DistanceType.HammingUnexpanded:
        return pairwise_unexpanded_pallas(x, y, "hamming") / x.shape[1]
    if m == DistanceType.CosineExpanded:
        return pairwise_pallas(x, y, "cosine")
    if m == DistanceType.CorrelationExpanded:
        x = x.to(torch.float32)
        y = y.to(torch.float32)
        return pairwise_pallas(x - x.mean(dim=1, keepdim=True),
                               y - y.mean(dim=1, keepdim=True), "cosine")
    if m == DistanceType.InnerProduct:
        # the 'inner' tile is the negated product (a distance for argmin)
        return -pairwise_pallas(x, y, "inner")
    x, y = _floating(x), _floating(y)
    if m == DistanceType.JaccardExpanded:
        both, x_only, y_only, _ = _bool_stats(x, y)
        union = both + x_only + y_only
        return 1.0 - torch.where(union > 0,
                                 both / torch.clamp_min(union, _EPS), 1.0)
    if m == DistanceType.HellingerExpanded:
        return _hellinger(x, y)
    if m == DistanceType.JensenShannon:
        return _jensen_shannon(x, y)
    if m == DistanceType.KLDivergence:
        return _kl(x, y)
    if m == DistanceType.RusselRaoExpanded:
        both, _, _, k = _bool_stats(x, y)
        return (k - both) / k
    if m == DistanceType.DiceExpanded:
        both, x_only, y_only, _ = _bool_stats(x, y)
        denom = 2 * both + x_only + y_only
        return 1.0 - torch.where(denom > 0,
                                 2 * both / torch.clamp_min(denom, _EPS),
                                 1.0)
    if m == DistanceType.Haversine:
        return _haversine(x, y)
    if m == DistanceType.BrayCurtis:
        return _braycurtis(x, y)
    raise ValueError(f"unsupported metric {metric}")


@with_matmul_precision
def pairwise_distance(res, x, y=None,
                      metric: DistanceType = DistanceType.L2Expanded,
                      p: float = 2.0, sqrt: Optional[bool] = None,
                      guard_mode: Optional[str] = None) -> torch.Tensor:
    """Full m x n distance matrix between rows of x [m, k] and y [n, k];
    ``y=None`` means y = x, and then the diagonal is exactly zero for
    every true metric (not for ``InnerProduct`` or
    ``RusselRaoExpanded``). ``p`` is ``LpUnexpanded``'s exponent. A
    tensor runs on its device; an array goes to ``res``'s device
    (``cuda:0`` by default)."""
    resolve_guard_mode(guard_mode)
    x = _as2d(x, res)
    self_dist = y is None
    y = x if self_dist else _as2d(y, res)
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"feature dims differ: {x.shape[1]} vs {y.shape[1]}")
    d = _dispatch_metric(x, y, metric, p, sqrt)
    if self_dist and metric not in (DistanceType.InnerProduct,
                                    DistanceType.RusselRaoExpanded):
        d.fill_diagonal_(0.0)
    return d


@with_matmul_precision
def fused_l2_nn_argmin(res, x, y, sqrt: bool = False):
    """1-NN under L2 without materialising distances: ``(min_dist [m],
    argmin [m])``. An array goes to ``res``'s device, as in
    :func:`pairwise_distance`. CUDA kernel: ``csrc/fused_argmin.cu``."""
    val, idx = fused_l2_argmin_pallas(_as2d(x, res), _as2d(y, res))
    return (exact_sqrt(val) if sqrt else val), idx
