"""IVF-Flat search worked out again from the database, the queries and
the coarse centroids it is judged against.

The centroids are the program's output (its quantizer's fit, judged on
its own by the k-means cell); the lists, the packing and the probe are
worked out here from them. A row or a probe that rounding could move is
left out: a row belongs to a list only when its nearest centroid beats
the second by more than ``tie``, and a query probes a list only when the
list beats the query's ``nprobe + 1``-th nearest centroid by more than
``tie``. What is left (the firm candidates) lies in every sound search's
candidate set, so a sound search's k-th best can be no worse than the
firm candidates' k-th best.
"""

from __future__ import annotations

import torch

from portbench.reference import exact_f32
from portbench.reference.knn import exact_topk, nearest_two


def firm_lists(queries: torch.Tensor, centres: torch.Tensor, nprobe: int,
               tie: float) -> torch.Tensor:
    """[q, n_lists] bool: the lists each query probes whatever the
    rounding."""
    n_lists = centres.shape[0]
    if nprobe >= n_lists:
        return torch.ones(queries.shape[0], n_lists, dtype=torch.bool,
                          device=queries.device)
    with exact_f32():
        d = ((queries * queries).sum(1)[:, None]
             + (centres * centres).sum(1)[None, :]
             - 2.0 * (queries @ centres.T))
    edge = torch.kthvalue(d, nprobe + 1, dim=1).values
    return d < (edge - tie)[:, None]


def probed_lists(queries: torch.Tensor, centres: torch.Tensor,
                 nprobe: int) -> torch.Tensor:
    """[q, nprobe] the lists each query probes (float32, no margin): the
    yardstick's count of what a search has to read."""
    with exact_f32():
        d = ((queries * queries).sum(1)[:, None]
             + (centres * centres).sum(1)[None, :]
             - 2.0 * (queries @ centres.T))
    return torch.topk(d, min(nprobe, centres.shape[0]), dim=1,
                      largest=False).indices


def firm_topk(db: torch.Tensor, queries: torch.Tensor,
              centres: torch.Tensor, k: int, nprobe: int, tie: float):
    """The k best firm candidates of each query: ``(dist, ids)``."""
    centres = centres.to(torch.float32)
    d1, label, d2 = nearest_two(db, centres)
    firm_row = (d2 - d1) > tie
    lists = firm_lists(queries, centres, nprobe, tie)

    def mask(lo, hi):
        return lists[lo:hi][:, label] & firm_row[None, :]

    return exact_topk(db, queries, k, mask=mask)
