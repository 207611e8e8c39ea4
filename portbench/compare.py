"""The numbers that decide ``correct``, each held against its limit.

Every number is a widest gap scaled by a reference distance, so it reads
about the same at any data scale. The limits live in each workload's
file, under ``limits``; ``PERF.md`` gives the readings each was set from.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from portbench.reference import kmeans as ref_kmeans
from portbench.reference.knn import direct_sq_l2, nearest_two

Checks = Dict[str, Tuple[float, float]]


def bad_id_rows(ids: torch.Tensor, n_db: int) -> int:
    """Rows with an id out of range or the same id twice."""
    out = (ids < 0) | (ids >= n_db)
    s, _ = torch.sort(ids.long(), dim=1)
    dup = torch.zeros_like(out)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    return int((out | dup).any(1).sum())


def knn_numbers(db, queries, got_d, got_i, ref_d) -> Dict[str, float]:
    """A search's answers against the reference's k best distances:

    - ``bad_id_rows``: rows with an id out of range or repeated;
    - ``dist_gap``: the widest amount by which the j-th best true
      distance of the returned ids exceeds the reference's j-th best;
    - ``reported_gap``: the widest gap between a returned distance and
      the true distance of its id;

    both gaps over the median of the reference's k-th distances."""
    k = ref_d.shape[1]
    true = direct_sq_l2(queries, db, got_i)
    true_sorted, _ = torch.sort(true, dim=1)
    scale = float(torch.median(ref_d[:, k - 1][torch.isfinite(
        ref_d[:, k - 1])]))
    have = torch.isfinite(ref_d)
    gap = torch.where(have, true_sorted - ref_d,
                      torch.zeros_like(ref_d))
    rep = (got_d.to(torch.float32) - true).abs()
    return {
        "bad_id_rows": float(bad_id_rows(got_i, db.shape[0])),
        "dist_gap": _finite_max(gap) / scale,
        "reported_gap": _finite_max(rep) / scale,
    }


def quantizer_numbers(x, centres, labels, ref_centres) -> Dict[str, float]:
    """A quantizer's centroids and each row's label (its cluster, or the
    list a row was packed into) against plain k-means:

    - ``label_gap``: the widest amount by which a row's label is farther
      than its nearest centroid (an out-of-range label is infinitely
      far);
    - ``mean_gap``: how far each centroid lies from the mean of the rows
      nearest to it, in standard errors of that mean, the median over
      the clusters (:func:`mean_gap`);
    - ``fit_excess``: the centroids' cost over the cost of
      ``ref_centres`` (the reference's own fit), less 1.

    ``label_gap`` is over the median distance of a row to its nearest
    centroid."""
    centres = centres.to(torch.float32)
    d1, near, _ = nearest_two(x, centres)
    k = centres.shape[0]
    lab = labels.long()
    bad = (lab < 0) | (lab >= k)
    mine = direct_sq_l2(x, centres, lab.clamp(0, k - 1)[:, None])[:, 0]
    mine = torch.where(bad, torch.full_like(mine, math.inf), mine)
    return {
        "label_gap": float((mine - d1).max()) / float(torch.median(d1)),
        "mean_gap": mean_gap(x, centres, near),
        "fit_excess": float(d1.to(torch.float64).sum())
        / ref_kmeans.cost(x, ref_centres) - 1.0,
    }


def mean_gap(x, c, near) -> float:
    """Median over clusters of ``|mean - c| * sqrt(n) / rms`` (clusters
    of two rows or more), ``near`` each row's nearest centroid: a Lloyd
    fit's centroid is such a mean, up to the rows that changed cluster
    in its last step."""
    k = c.shape[0]
    n = torch.bincount(near, minlength=k).to(torch.float64)
    sums = torch.zeros(k, x.shape[1], dtype=torch.float64,
                       device=x.device).index_add_(0, near,
                                                   x.to(torch.float64))
    mean = sums / n.clamp_min(1)[:, None]
    spread = torch.zeros(k, dtype=torch.float64, device=x.device)
    spread.index_add_(0, near, ((x.to(torch.float64) - mean[near]) ** 2)
                      .sum(1))
    rms = (spread / n.clamp_min(1)).sqrt()
    keep = (n >= 2) & (rms > 0)
    z = (mean - c.to(torch.float64)).norm(dim=1) * n.sqrt() / rms
    return float(z[keep].median())


def _finite_max(t: torch.Tensor) -> float:
    """The largest entry; +inf if any entry is NaN or infinite."""
    if t.numel() == 0:
        return 0.0
    if not bool(torch.isfinite(t).all()):
        return math.inf
    return float(t.max())


def held(numbers: Dict[str, float], limits: Dict[str, float]) -> Checks:
    """Each number beside its limit; a number with no limit is an
    error in the workload's file."""
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}")
    return {name: (float(numbers[name]), float(limits[name]))
            for name in numbers}


def all_within(checks: Checks) -> bool:
    """True when every number is at most its limit (NaN fails)."""
    return all(v <= lim for v, lim in checks.values())
