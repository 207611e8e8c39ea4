"""First and second moments (counterpart of ``raft_tpu/stats/moments.py``),
as torch reductions on the input's device (an array goes to the
process-wide handle's, ``cuda:0``). ``axis`` 0 gives per-column
statistics over the rows (the reference's default layout), 1 per-row.
``cov`` takes its product at the precision tier in effect
(``linalg.blas``; 'high' is bf16x3, never TF32), f64 data in f64.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.util.precision import current_mode, with_matmul_precision


def _x(x) -> torch.Tensor:
    """The input as a floating tensor: int64 becomes f64, narrower
    integers and booleans f32 (``jnp.mean``'s promotion under x64)."""
    x = as_tensor(x)
    if x.is_floating_point():
        return x
    return x.to(torch.float64 if x.dtype == torch.int64 else torch.float32)


def mean(x, axis: int = 0):
    """Per-column (axis 0) or per-row (axis 1) mean."""
    return torch.mean(_x(x), dim=axis)


def sum_(x, axis: int = 0):
    """Column or row sums (integers in int64)."""
    return torch.sum(as_tensor(x), dim=axis)


def vars_(x, mu=None, axis: int = 0, sample: bool = True):
    """Variance about ``mu`` (the mean if None); ``sample`` divides by
    n - 1."""
    x = _x(x)
    n = x.shape[axis]
    mu = torch.mean(x, dim=axis) if mu is None else torch.as_tensor(
        mu, device=x.device)
    centered = x - mu.unsqueeze(axis)
    return torch.sum(centered * centered, dim=axis) / ((n - 1) if sample
                                                      else n)


def stddev(x, mu=None, axis: int = 0, sample: bool = True):
    return torch.sqrt(vars_(x, mu=mu, axis=axis, sample=sample))


def meanvar(x, axis: int = 0, sample: bool = True):
    """``(mean, variance)``."""
    x = _x(x)
    mu = torch.mean(x, dim=axis)
    return mu, vars_(x, mu=mu, axis=axis, sample=sample)


def mean_center(x, mu=None, axis: int = 0):
    """``x`` less its mean (or ``mu``) along ``axis``."""
    x = _x(x)
    mu = torch.mean(x, dim=axis) if mu is None else torch.as_tensor(
        mu, device=x.device)
    return x - mu.unsqueeze(axis)


def mean_add(x, mu, axis: int = 0):
    """The inverse of :func:`mean_center`."""
    x = as_tensor(x)
    return x + torch.as_tensor(mu, device=x.device).unsqueeze(axis)


def minmax(x, axis: int = 0, rows=None, row_ids=None):
    """``(min, max)`` along ``axis``, over the rows ``row_ids`` if given,
    else the first ``rows`` rows if given, else all."""
    x = as_tensor(x)
    if row_ids is not None:
        x = x[torch.as_tensor(row_ids, device=x.device).long()]
    elif rows is not None:
        x = x[:rows]
    return torch.amin(x, dim=axis), torch.amax(x, dim=axis)


@with_matmul_precision
def cov(x, mu=None, sample: bool = True, center: bool = True):
    """Covariance [d, d] of the rows of ``x`` [n, d]: ``xcᵀ·xc / (n -
    1)`` (``n`` without ``sample``), xc the centered rows (or ``x`` with
    ``center=False``), the product at the tier in effect."""
    from raft_tpu_torch.linalg.blas import _product

    x = _x(x)
    n = x.shape[0]
    if center:
        mu = torch.mean(x, dim=0) if mu is None else torch.as_tensor(
            mu, device=x.device)
        x = x - mu[None, :]
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    prod = _product(x, x, True, False, ct, current_mode()).to(x.dtype)
    return prod / ((n - 1) if sample else n)


def weighted_mean(x, weights, axis: int = 0):
    """Weighted mean along ``axis``; ``weights`` has x.shape[axis]
    entries."""
    x = _x(x)
    w = torch.as_tensor(weights, device=x.device).to(x.dtype)
    return torch.tensordot(w, x, dims=([0], [axis])) / torch.sum(w)


def row_weighted_mean(x, weights):
    """Per-row weighted mean over the columns (``weights``: n_cols)."""
    return weighted_mean(x, weights, axis=1)


def col_weighted_mean(x, weights):
    """Per-column weighted mean over the rows (``weights``: n_rows)."""
    return weighted_mean(x, weights, axis=0)
