"""k-means (Lloyd) on one device over the fused contraction kernels
(counterpart of the single-device half of ``raft_tpu/cluster/kmeans.py``).

- Each Lloyd iteration is one fused pass (``csrc/fused_lloyd.cu``):
  distances, first-min labels, and the per-centroid sums and counts,
  accumulated in a fixed order so a fit is bitwise reproducible.
- At tier ``'high'`` X's bf16 halves and norms are hoisted out of the
  loop once per fit (:func:`~raft_tpu_torch.linalg.contractions.lloyd_prepare`).
- Assignment (final labels, ``kmeans_predict``, k-means|| candidate
  weights) is the fused argmin (``csrc/fused_argmin.cu``); the
  distance embedding (``kmeans_transform``) is the pairwise tile
  (``csrc/pairwise_tile.cu``).

The fit is a host loop that tests convergence at the same points as the
reference package, so ``n_iter`` matches it for the same parameters.
CUDA graphs, deadlines, observability hooks and the minibatch, MNMG and
elastic fits are later slices (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import enum
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.guards import ConvergenceError, ConvergenceReport
from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.distance.pairwise import DistanceType, pairwise_distance
from raft_tpu_torch.linalg.contractions import (fused_l2_argmin_pallas,
                                                fused_lloyd_pallas,
                                                fused_lloyd_prepared,
                                                lloyd_prepare)
from raft_tpu_torch.matrix.epilogue import label_onehot
from raft_tpu_torch.random.rng_state import RngState
from raft_tpu_torch.util.input_validation import expect_2d, expect_finite
from raft_tpu_torch.util.precision import with_matmul_precision


class KMeansInit(enum.Enum):
    """Initialization methods, with the reference package's values."""

    KMEANS_PLUS_PLUS = "kmeans++"
    RANDOM = "random"
    ARRAY = "array"  # caller-supplied centroids


@dataclasses.dataclass
class KMeansParams:
    """Hyper-parameters, as in the reference package. ``check_every``:
    convergence is polled every this many iterations (each poll is a
    device-to-host copy of the inertia)."""

    n_clusters: int = 8
    max_iter: int = 300
    tol: float = 1e-4
    init: KMeansInit = KMeansInit.KMEANS_PLUS_PLUS
    oversampling_factor: float = 2.0
    seed: int = 0
    check_every: int = 1


def _as_data(x, res) -> torch.Tensor:
    """:func:`~raft_tpu_torch.core.resources.as_tensor`, as f32."""
    x = as_tensor(x, res)
    if not x.is_floating_point():
        raise TypeError(f"expected floating data, got {x.dtype}")
    return x.to(torch.float32).contiguous()


def _assign(x, centroids):
    """Nearest-centroid ``(dist², labels)`` through the fused argmin."""
    return fused_l2_argmin_pallas(x, centroids)


def _finish_update(sums, counts, old_centroids):
    """sums/counts -> new centroids; an empty cluster keeps its centroid.
    Counts may be fractional under sample weights: divide by the actual
    positive mass."""
    safe = torch.where(counts > 0, counts, torch.ones_like(counts))[:, None]
    new = (sums / safe).to(old_centroids.dtype)
    return torch.where(counts[:, None] > 0, new, old_centroids)


@with_matmul_precision
def lloyd_step(x, centroids, n_clusters: int):
    """One Lloyd iteration: ``(new_centroids, inertia, labels)``, with
    inertia and labels measured against the input centroids."""
    sums, counts, dist, labels = fused_lloyd_pallas(x, centroids)
    return _finish_update(sums, counts, centroids), torch.sum(dist), labels


@with_matmul_precision
def lloyd_step_prepared(ops, centroids, *, m: int):
    """:func:`lloyd_step` against the operands of ``lloyd_prepare``;
    bitwise the same result."""
    sums, counts, dist, labels = fused_lloyd_prepared(ops, centroids, m=m)
    return _finish_update(sums, counts, centroids), torch.sum(dist), labels


@with_matmul_precision
def lloyd_iterate_prepared(ops, centroids, n_steps: int, *, m: int):
    """``n_steps`` prepared Lloyd iterations back to back; returns the
    last step's ``(centroids, inertia, labels)``."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    c = centroids
    for _ in range(n_steps):
        c, inertia, labels = lloyd_step_prepared(ops, c, m=m)
    return c, inertia, labels


def _weighted_sums(x, w, labels, dist, n_clusters: int):
    """Weighted ``(sums, counts, inertia term)`` from an assignment. The
    one-hot product stays a matmul, as the reference package leaves it
    to XLA outside its kernels."""
    wf = w.to(torch.float32)
    oh = label_onehot(labels, n_clusters)
    return oh.T @ (x * wf[:, None]), oh.T @ wf, torch.sum(dist * wf)


@with_matmul_precision
def weighted_lloyd_step(x, w, centroids, n_clusters: int):
    """Sample-weighted Lloyd iteration: fused argmin assignment, weighted
    one-hot update. ``w == 1`` gives :func:`lloyd_step`'s centroids."""
    dist, labels = _assign(x, centroids)
    sums, counts, winertia = _weighted_sums(x, w, labels, dist, n_clusters)
    return _finish_update(sums, counts, centroids), winertia, labels


def _validate_sample_weights(w: torch.Tensor, n_rows: int) -> None:
    if tuple(w.shape) != (n_rows,):
        raise ValueError(
            f"sample_weights shape {tuple(w.shape)} != ({n_rows},)")
    if not (bool(torch.isfinite(w).all()) and bool((w >= 0).all())
            and float(w.sum()) > 0):
        raise ValueError("sample_weights must be finite, non-negative, "
                         "with positive total")


def _weighted_plus_plus(rng, cand, w, n_clusters: int):
    """Weighted k-means++ on the small candidate set (host numpy)."""
    ncand = cand.shape[0]
    centers = np.empty((n_clusters, cand.shape[1]), cand.dtype)
    first = rng.choice(ncand, p=w / w.sum())
    centers[0] = cand[first]
    d2 = np.sum((cand - centers[0][None, :]) ** 2, axis=1)
    for i in range(1, n_clusters):
        probs = w * d2
        total = probs.sum()
        if total <= 0:
            nxt = rng.choice(ncand)
        else:
            nxt = rng.choice(ncand, p=probs / total)
        centers[i] = cand[nxt]
        d2 = np.minimum(d2, np.sum((cand - cand[nxt][None, :]) ** 2, axis=1))
    return centers


def _kmeans_plus_plus(gen: torch.Generator, x, n_clusters: int,
                      oversampling_factor: float = 2.0,
                      sample_weights=None):
    """k-means|| seeding (Bahmani et al.): five oversampled D² rounds over
    the data, each a fused argmin pass against the new candidates, then
    weighted k-means++ on the candidate set. Random draws come from
    ``gen`` (on x's device), never from a global RNG."""
    m = x.shape[0]
    dev = x.device
    if sample_weights is None:
        first = int(torch.randint(0, m, (1,), generator=gen, device=dev))
        wts = None
    else:
        wts = sample_weights.to(torch.float32)
        first = int(torch.multinomial(torch.clamp_min(wts, 1e-30), 1,
                                      generator=gen))
    cand = [x[first][None, :].cpu().numpy()]
    d2 = torch.sum((x - x[first][None, :]) ** 2, dim=1)
    ell = max(1.0, oversampling_factor * n_clusters)
    for _ in range(5):
        mass = d2 if wts is None else d2 * wts
        total = float(torch.sum(mass))
        if total <= 0:
            break
        probs = torch.clamp_max(ell * mass / total, 1.0)
        picked = torch.nonzero(
            torch.rand(m, generator=gen, device=dev) < probs)[:, 0]
        if picked.numel() == 0:
            continue
        new_pts = x[picked]
        cand.append(new_pts.cpu().numpy())
        d2 = torch.minimum(d2, fused_l2_argmin_pallas(x, new_pts)[0])
    cand_np = np.concatenate(cand, axis=0)
    seed = int(torch.randint(0, np.iinfo(np.int32).max, (1,),
                             generator=gen, device=dev))
    rng = np.random.default_rng(seed)
    if cand_np.shape[0] <= n_clusters:
        # too few candidates: top up with random rows (weighted, so a
        # zero-weight point never becomes a seed)
        p = None
        if wts is not None:
            p = wts.cpu().numpy().astype(np.float64)
            p = p / p.sum()
        extra = rng.choice(m, n_clusters - cand_np.shape[0] + 1,
                           replace=False, p=p)
        cand_np = np.concatenate(
            [cand_np, x[torch.as_tensor(extra, device=dev)].cpu().numpy()])
    # weight the candidates by the (weighted) mass each one serves
    _, labels = _assign(x, torch.as_tensor(cand_np, device=dev))
    w = np.bincount(
        labels.cpu().numpy(), minlength=cand_np.shape[0],
        weights=None if wts is None else wts.cpu().numpy().astype(np.float64)
    ).astype(np.float64) + 1e-3
    centers = _weighted_plus_plus(rng, cand_np.astype(np.float64), w,
                                  n_clusters)
    return torch.as_tensor(centers, dtype=x.dtype, device=dev)


def _init_centroids(params: KMeansParams, x, centroids,
                    sample_weights=None):
    # explicit centroids always win (warm start), as in the reference
    if centroids is not None:
        return torch.as_tensor(centroids).to(device=x.device,
                                             dtype=x.dtype).clone()
    if params.init == KMeansInit.ARRAY:
        raise ValueError("init=ARRAY requires centroids")
    gen = RngState(seed=params.seed).generator(x.device)
    if params.init == KMeansInit.RANDOM:
        idx = torch.randperm(x.shape[0], generator=gen,
                             device=x.device)[:params.n_clusters]
        return x[idx].clone()
    return _kmeans_plus_plus(gen, x, params.n_clusters,
                             params.oversampling_factor,
                             sample_weights=sample_weights)


def _finish_report(converged: bool, n_iter: int, rel_change: float,
                   params: KMeansParams, strict: bool, op: str):
    report = ConvergenceReport(converged=converged, n_iter=int(n_iter),
                               residual=float(rel_change),
                               tol=float(params.tol))
    if not converged:
        if strict:
            raise ConvergenceError(
                f"{op}: inertia change {rel_change:.3e} still above tol "
                f"{params.tol:.3e} after max_iter={params.max_iter} "
                "Lloyd iterations (strict=True)", report=report, op=op)
        warnings.warn(f"{op}: not converged after {n_iter} iterations "
                      f"(relative inertia change {rel_change:.3e} > tol "
                      f"{params.tol:.3e})", RuntimeWarning, stacklevel=3)
    return report


def _resolve_sync_every(sync_every: Optional[int]) -> int:
    """``sync_every`` validated as in the reference package's
    ``runtime.compiled_driver.resolve_sync_every``; ``None`` is 1."""
    if sync_every is None:
        return 1
    n = int(sync_every)
    if n < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    return n


def kmeans_fit(res, params: KMeansParams, x,
               centroids: Optional[torch.Tensor] = None,
               sample_weights=None, strict: bool = False,
               return_report: bool = False,
               sync_every: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Lloyd's algorithm: ``(centroids, inertia, labels, n_iter)``.

    ``x`` as a tensor runs on its device; as an array it goes to the
    handle's device. Convergence: the relative change of the inertia
    between two polls is at most ``tol``. Polls come every
    ``check_every`` iterations, and at ``max_iter``. With
    ``sync_every > 1`` the reference package tests convergence in its
    compiled loop after every iteration; the port's host loop does the
    same, so ``n_iter`` matches it in both modes.

    ``strict=True`` raises :class:`ConvergenceError` when ``max_iter``
    passes unconverged; ``return_report=True`` appends the
    :class:`ConvergenceReport`. ``sample_weights`` [m] weight the update
    and the inertia."""
    op = "cluster.kmeans_fit"
    x = _as_data(x, res)
    expect_2d(x, name="kmeans_fit: x")
    expect_finite(x, name="kmeans_fit: x")
    w = None
    if sample_weights is not None:
        w = torch.as_tensor(sample_weights, device=x.device)
        _validate_sample_weights(w, x.shape[0])
        w = w.to(torch.float32)
    sync = _resolve_sync_every(sync_every)
    check = 1 if sync > 1 else max(1, int(params.check_every))
    c = _init_centroids(params, x, centroids, sample_weights=w)
    ops, meta = (None, None) if w is not None \
        else lloyd_prepare(x, params.n_clusters)
    prev_inertia = None
    n_iter = 0
    converged = False
    rel_change = float("inf")
    while n_iter < params.max_iter:
        block = min(check, params.max_iter - n_iter)
        if ops is not None:
            c, inertia, _ = lloyd_iterate_prepared(ops, c, block, **meta)
        else:
            for _ in range(block):
                if w is None:
                    c, inertia, _ = lloyd_step(x, c, params.n_clusters)
                else:
                    c, inertia, _ = weighted_lloyd_step(x, w, c,
                                                        params.n_clusters)
        n_iter += block
        cur = float(inertia)
        if prev_inertia is not None:
            rel_change = abs(prev_inertia - cur) / max(prev_inertia, 1e-30)
            if rel_change <= params.tol:
                converged = True
                break
        prev_inertia = cur
    # the step's labels are against its input centroids: assign once more
    # so the returned triple is self-consistent
    dist, labels = _assign(x, c)
    inertia = torch.sum(dist) if w is None else torch.sum(dist * w)
    report = _finish_report(converged, n_iter, rel_change, params, strict,
                            op=op)
    if return_report:
        return c, inertia, labels, n_iter, report
    return c, inertia, labels, n_iter


@with_matmul_precision
def kmeans_predict(res, x, centroids):
    """Assignment only: ``(labels, inertia)``."""
    x = _as_data(x, res)
    dist, labels = _assign(x, torch.as_tensor(centroids, device=x.device))
    return labels, torch.sum(dist)


@with_matmul_precision
def kmeans_transform(res, x, centroids):
    """Distance-to-centroid embedding [m, n_clusters] (L2, rooted)."""
    x = _as_data(x, res)
    return pairwise_distance(res, x, torch.as_tensor(centroids,
                                                     device=x.device),
                             metric=DistanceType.L2SqrtExpanded)


def kmeans_fit_predict(res, params: KMeansParams, x,
                       centroids: Optional[torch.Tensor] = None,
                       sample_weights=None, strict: bool = False,
                       return_report: bool = False):
    return kmeans_fit(res, params, x, centroids,
                      sample_weights=sample_weights, strict=strict,
                      return_report=return_report)


@with_matmul_precision
def cluster_cost(res, x, centroids):
    """Sum of squared distances of every point to its nearest centroid."""
    x = _as_data(x, res)
    dist, _ = _assign(x, torch.as_tensor(centroids, device=x.device))
    return torch.sum(dist)
