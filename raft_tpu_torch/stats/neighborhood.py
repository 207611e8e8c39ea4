"""Neighborhood-preservation scores (counterpart of
``raft_tpu/stats/neighborhood.py``).

``trustworthiness_score`` runs in batches of rows: the embedded
distances (self at +inf) give each row's k nearest through
``matrix.select_k`` (the insertion drain of ``csrc/topk_insert.cu``,
whose smaller-column tie rule picks the set the reference's
``lax.top_k(-d)`` picks), the original distances rank them by counting
the points strictly closer, as the reference does. Both distances come
from ``pairwise_distance`` (``L2SqrtUnexpanded`` by default:
``csrc/unexpanded_tile.cu``). Scores are in f64.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.resources import as_tensor

_F64 = torch.float64


def neighborhood_recall(indices, ref_indices, distances=None,
                        ref_distances=None, eps: float = 1e-4):
    """The fraction of k-NN indices found in the reference's row; with
    both distances given, an index also counts where its distance is
    within ``eps`` of one of the reference row's (ties)."""
    idx = as_tensor(indices)
    ref = torch.as_tensor(ref_indices, device=idx.device)
    n, k = idx.shape
    match = idx[:, :, None] == ref[:, None, :]
    if distances is not None and ref_distances is not None:
        d = torch.as_tensor(distances, device=idx.device)
        rd = torch.as_tensor(ref_distances, device=idx.device)
        match = match | ((d[:, :, None] - rd[:, None, :]).abs() <= eps)
    hits = torch.sum(torch.any(match, dim=2).to(_F64))
    return hits / (n * k)


def trustworthiness_score(res, x, x_embedded, n_neighbors: int,
                          metric=None, batch_size: int = 512):
    """Trustworthiness of an embedding:

        T = 1 - 2 / (n k (2n - 3k - 1)) * sum_i sum_{j in kNN_emb(i)}
                max(0, rank_orig(i, j) - k)

    with ``rank_orig`` 1-based among the other points, from the count of
    points strictly closer than j in the original space."""
    from raft_tpu_torch.distance.pairwise import (DistanceType,
                                                  pairwise_distance)
    from raft_tpu_torch.matrix.select_k import SelectAlgo, select_k

    if metric is None:
        metric = DistanceType.L2SqrtUnexpanded
    x = as_tensor(x, res)
    emb = torch.as_tensor(x_embedded, device=x.device)
    n = x.shape[0]
    k = n_neighbors
    penalty = torch.zeros((), dtype=_F64, device=x.device)
    for start in range(0, n, batch_size):
        xb = x[start:start + batch_size]
        eb = emb[start:start + batch_size]
        rows = torch.arange(xb.shape[0], device=x.device)
        d_emb = pairwise_distance(res, eb, emb, metric=metric)     # (b, n)
        d_emb[rows, start + rows] = float("inf")                   # self out
        _, nn_emb = select_k(res, d_emb, k, select_min=True,
                             algo=SelectAlgo.WARPSORT_FILTERED)
        d_orig = pairwise_distance(res, xb, x, metric=metric)      # (b, n)
        self_d = d_orig[rows, start + rows]
        d_nn = torch.gather(d_orig, 1, nn_emb.long())              # (b, k)
        rank0 = torch.sum(d_orig[:, None, :] < d_nn[:, :, None], dim=2)
        rank0 = rank0 - (self_d[:, None] < d_nn).long()            # self out
        rank1 = rank0.to(_F64) + 1.0
        penalty = penalty + torch.sum(torch.clamp_min(rank1 - k, 0.0))
    return 1.0 - penalty * (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)))
