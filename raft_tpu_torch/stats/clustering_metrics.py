"""External clustering scores and the silhouette (counterpart of
``raft_tpu/stats/clustering_metrics.py``).

One contingency table, one ``torch.bincount`` of ``true * n_pred +
pred``, feeds every pair score in closed form (the pair counts are sums
of ``C(n_ij, 2)`` over the table and its margins), in f64: the
reference's ``jnp.result_type(float)`` under x64. A class count that is
too small raises ``ValueError``; no count is dropped.

``silhouette_score`` takes its distances from ``pairwise_distance``
(``L2Unexpanded`` by default: ``csrc/unexpanded_tile.cu``) and each
row's per-cluster distance sums from ``linalg.reduce_cols_by_key``
(``csrc/csr_spmm.cu``: in-order f32 sums of each cluster's columns at
every tier), where the reference multiplies by a cluster one-hot at the
tier in effect (ROADMAP.md, "Deliberate divergences").
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.util.precision import with_matmul_precision

_F64 = torch.float64


def _labels(y, device=None) -> torch.Tensor:
    y = as_tensor(y) if device is None else torch.as_tensor(y, device=device)
    return y.long()


def _num_classes(y: torch.Tensor, n=None) -> int:
    return int(n) if n is not None else int(y.max()) + 1


def contingency_matrix(y_true, y_pred, n_classes_true: int = None,
                       n_classes_pred: int = None):
    """int64 [n_true, n_pred] co-occurrence counts of labels numbered
    from 0 (``label.make_monotonic`` first, as in the reference's
    workflow). Labels at or past a given class count, or below 0, raise
    ``ValueError``."""
    yt = _labels(y_true)
    yp = _labels(y_pred, yt.device)
    nt = _num_classes(yt, n_classes_true)
    npred = _num_classes(yp, n_classes_pred)
    if yt.numel():
        lo = torch.stack([yt.min(), yp.min()]).tolist()
        mt, mp = torch.stack([yt.max(), yp.max()]).tolist()
        if mt >= nt or mp >= npred or min(lo) < 0:
            raise ValueError(
                f"labels exceed the class count: labels in [{min(lo)}, "
                f"({mt}, {mp})] vs n_classes ({nt}, {npred})")
    flat = yt * npred + yp
    return torch.bincount(flat, minlength=nt * npred).reshape(nt, npred)


def _comb2(x: torch.Tensor) -> torch.Tensor:
    x = x.to(_F64)
    return x * (x - 1.0) / 2.0


def _pair_sums(y_a, y_b, n_classes):
    """``(sum_ij, sum_a, sum_b, total)``: C(., 2) summed over the table,
    its row and column margins, and of n."""
    c = contingency_matrix(y_a, y_b, n_classes, n_classes)
    total = _comb2(torch.tensor(float(c.sum()), device=c.device))
    return (torch.sum(_comb2(c)), torch.sum(_comb2(c.sum(1))),
            torch.sum(_comb2(c.sum(0))), total)


def rand_index(y_a, y_b, n_classes: int = None):
    """The Rand index, in closed form over the contingency table."""
    sum_ij, sum_a, sum_b, total = _pair_sums(y_a, y_b, n_classes)
    return (total + 2.0 * sum_ij - sum_a - sum_b) / total


def adjusted_rand_index(y_a, y_b, n_classes: int = None):
    """The Rand index corrected for chance; 1.0 where the correction's
    denominator is 0 (all singletons or one cluster)."""
    sum_ij, sum_a, sum_b, total = _pair_sums(y_a, y_b, n_classes)
    expected = sum_a * sum_b / total
    denom = 0.5 * (sum_a + sum_b) - expected
    return torch.where(denom == 0, torch.ones_like(denom),
                       (sum_ij - expected) / denom)


def mutual_info_score(y_a, y_b, n_classes: int = None):
    """Mutual information (natural log) of two labelings."""
    c = contingency_matrix(y_a, y_b, n_classes, n_classes).to(_F64)
    pij = c / torch.sum(c)
    pi = torch.sum(pij, dim=1, keepdim=True)
    pj = torch.sum(pij, dim=0, keepdim=True)
    live = pij > 0
    logterm = torch.where(live, torch.log(pij / (pi * pj)),
                          torch.zeros_like(pij))
    return torch.sum(pij * logterm)


def _conditional_entropy(c: torch.Tensor) -> torch.Tensor:
    """H(rows | cols) of a contingency table."""
    pj = torch.sum(c, dim=0)
    pij = c / torch.sum(c)
    live = c > 0
    ratio = torch.where(live, c / pj[None, :], torch.ones_like(c))
    return -torch.sum(torch.where(live, pij * torch.log(ratio),
                                  torch.zeros_like(c)))


def _label_entropy(counts: torch.Tensor, n) -> torch.Tensor:
    p = counts / n
    return -torch.sum(torch.where(p > 0, p * torch.log(p),
                                  torch.zeros_like(p)))


def homogeneity_score(y_true, y_pred, n_classes: int = None):
    """``1 - H(C|K) / H(C)`` (1.0 where H(C) = 0)."""
    c = contingency_matrix(y_true, y_pred, n_classes, n_classes).to(_F64)
    h_c = _label_entropy(torch.sum(c, dim=1), torch.sum(c))
    h_ck = _conditional_entropy(c)
    return torch.where(h_c == 0, torch.ones_like(h_c), 1.0 - h_ck / h_c)


def completeness_score(y_true, y_pred, n_classes: int = None):
    """Homogeneity with the roles swapped."""
    return homogeneity_score(y_pred, y_true, n_classes)


def v_measure(y_true, y_pred, n_classes: int = None, beta: float = 1.0):
    """The weighted harmonic mean of homogeneity and completeness (0.0
    where both are 0)."""
    h = homogeneity_score(y_true, y_pred, n_classes)
    c = completeness_score(y_true, y_pred, n_classes)
    denom = beta * h + c
    return torch.where(denom == 0, torch.zeros_like(denom),
                       (1.0 + beta) * h * c / denom)


@with_matmul_precision
def silhouette_score(res, x, labels, n_clusters: int, metric=None,
                     chunk: int = 4096):
    """Mean silhouette coefficient ``s(i) = (b - a) / max(a, b)``, 0 for a
    point alone in its cluster, in x's dtype.

    For each ``chunk`` rows: their distances to every row
    (``pairwise_distance``), each cluster's sum of them
    (``linalg.reduce_cols_by_key``), then ``a`` the mean to the own
    cluster without the point itself and ``b`` the least mean to
    another non-empty cluster."""
    from raft_tpu_torch.distance.pairwise import (DistanceType,
                                                  pairwise_distance)
    from raft_tpu_torch.linalg.reduce import reduce_cols_by_key

    if metric is None:
        metric = DistanceType.L2Unexpanded
    x = as_tensor(x, res)
    labels = torch.as_tensor(labels, device=x.device).long()
    n = x.shape[0]
    cols = torch.arange(n_clusters, device=x.device)
    counts = torch.bincount(labels[(labels >= 0) & (labels < n_clusters)],
                            minlength=n_clusters).to(x.dtype)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    inf = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    sil_sum = zero
    for start in range(0, n, chunk):
        xb = x[start:start + chunk]
        lb = labels[start:start + chunk]
        d = pairwise_distance(res, xb, x, metric=metric)        # (b, n)
        sums = reduce_cols_by_key(res, d, labels, n_clusters)   # (b, k)
        own = counts[lb]
        at = torch.arange(xb.shape[0], device=x.device)
        alone = own <= 1
        a = torch.where(alone, zero, sums[at, lb]
                        / torch.clamp_min(own - 1, 1))
        mean_other = sums / torch.clamp_min(counts, 1)[None, :]
        mean_other = torch.where((cols[None, :] == lb[:, None])
                                 | (counts[None, :] == 0), inf, mean_other)
        b = torch.amin(mean_other, dim=1)
        s = torch.where(alone, zero, (b - a) / torch.clamp_min(
            torch.maximum(a, b), 1e-30))
        sil_sum = sil_sum + torch.sum(s)
    return sil_sum / n
