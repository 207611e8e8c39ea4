"""k-means in plain PyTorch: the reference's own fit (k-means++ seeding,
then Lloyd iterations) and the cost of given centroids.

The fit starts from its own seeding, drawn with the run's seed; it never
sees the program's initial or final centroids. float32, TF32 off.
"""

from __future__ import annotations

import torch

from portbench.reference import exact_f32
from portbench.reference.knn import nearest_two


def cost(x: torch.Tensor, centres: torch.Tensor) -> float:
    """Sum over rows of the squared distance to the nearest centre
    (float64 sum)."""
    d1, _, _ = nearest_two(x, centres)
    return float(d1.to(torch.float64).sum())


def _assign(x, centres, block=65536):
    labels = []
    with exact_f32():
        cn = (centres * centres).sum(1)
        for lo in range(0, x.shape[0], block):
            xb = x[lo:lo + block]
            d = (xb * xb).sum(1)[:, None] + cn[None, :] - 2.0 * (xb @ centres.T)
            labels.append(torch.argmin(d, dim=1))
    return torch.cat(labels)


def plus_plus(x: torch.Tensor, n_clusters: int,
              gen: torch.Generator) -> torch.Tensor:
    """k-means++ seeding (Arthur and Vassilvitskii), one centre a step."""
    m = x.shape[0]
    first = torch.randint(0, m, (1,), generator=gen, device=x.device)
    centres = [x[first]]
    d2 = ((x - x[first]) ** 2).sum(1)
    for _ in range(1, n_clusters):
        nxt = torch.multinomial(d2.clamp_min(0), 1, generator=gen)
        c = x[nxt]
        centres.append(c)
        d2 = torch.minimum(d2, ((x - c) ** 2).sum(1))
    return torch.cat(centres)


def fit(x: torch.Tensor, n_clusters: int, iters: int,
        gen: torch.Generator) -> torch.Tensor:
    """``iters`` Lloyd iterations from k-means++; an empty cluster keeps
    its centre."""
    x = x.to(torch.float32)
    c = plus_plus(x, n_clusters, gen)
    for _ in range(iters):
        lab = _assign(x, c)
        sums = torch.zeros_like(c).index_add_(0, lab, x)
        counts = torch.bincount(lab, minlength=n_clusters).to(x.dtype)
        c = torch.where(counts[:, None] > 0,
                        sums / counts.clamp_min(1)[:, None], c)
    return c
