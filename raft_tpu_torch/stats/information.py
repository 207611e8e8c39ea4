"""Information-theoretic statistics and model-selection criteria
(counterpart of ``raft_tpu/stats/information.py``). The entropy is
computed in f64 (the reference's ``jnp.result_type(float)`` under x64)."""

from __future__ import annotations

import enum
import math

import torch

from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.stats.histogram import histogram


def entropy(labels, lower: int = None, upper: int = None):
    """Shannon entropy (natural log) of integer labels in [lower, upper)
    (lower 0 and upper max + 1 by default)."""
    labels = as_tensor(labels)
    if lower is None:
        lower = 0
    n_classes = (int(upper - lower) if upper is not None
                 else int(labels.max()) + 1 - lower)
    counts = histogram(labels - lower, n_classes)[:, 0]
    p = counts.to(torch.float64) / labels.shape[0]
    return -torch.sum(torch.where(p > 0, p * torch.log(p),
                                  torch.zeros_like(p)))


def kl_divergence(p, q):
    """KL(P || Q) = sum p log(p / q), the terms with p = 0 skipped."""
    p = as_tensor(p)
    q = torch.as_tensor(q, device=p.device)
    return torch.sum(torch.where(p > 0, p * torch.log(p / q),
                                 torch.zeros((), dtype=p.dtype,
                                             device=p.device)))


class IC_Type(enum.Enum):
    """The reference's criteria, with its values."""

    AIC = "aic"
    AICc = "aicc"
    BIC = "bic"


def information_criterion_batched(loglikelihood, ic_type: IC_Type,
                                  n_params: int, n_samples: int):
    """``-2 ll + penalty`` for each batch member: AIC ``2k``, AICc
    ``2k + 2k(k + 1) / (n - k - 1)``, BIC ``k log n``."""
    ll = as_tensor(loglikelihood)
    k, n = n_params, n_samples
    if ic_type is IC_Type.AIC:
        penalty = 2.0 * k
    elif ic_type is IC_Type.AICc:
        penalty = 2.0 * k + (2.0 * k * (k + 1)) / (n - k - 1)
    elif ic_type is IC_Type.BIC:
        penalty = math.log(float(n)) * k
    else:
        raise ValueError(f"unknown IC type {ic_type}")
    return -2.0 * ll + penalty


def cluster_dispersion(centroids, cluster_sizes, n_points: int = None):
    """``sqrt(sum_i n_i ||c_i - mu||^2)`` about the size-weighted mean
    ``mu = sum_i n_i c_i / N`` (N the sizes' sum unless given)."""
    c = as_tensor(centroids)
    sizes = torch.as_tensor(cluster_sizes, device=c.device)
    if n_points is None:
        n_points = torch.sum(sizes)
    w = sizes.to(c.dtype)
    mu = torch.sum(c * w[:, None], dim=0) / n_points
    d2 = torch.sum((c - mu[None, :]) ** 2, dim=1)
    return torch.sqrt(torch.sum(d2 * w))


def information_criterion(loglikelihood, ic_type: IC_Type, n_params: int,
                          n_samples: int):
    """The scalar spelling of :func:`information_criterion_batched`."""
    return information_criterion_batched(loglikelihood, ic_type, n_params,
                                         n_samples)
