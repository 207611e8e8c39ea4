"""Classification and regression scores (counterpart of
``raft_tpu/stats/regression_metrics.py``); the accuracy and the error
means in f64, as the reference's ``jnp.result_type(float)`` under x64."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.resources import as_tensor

_F64 = torch.float64


def accuracy(predictions, ref_predictions):
    """The fraction of exact matches."""
    p = as_tensor(predictions)
    r = torch.as_tensor(ref_predictions, device=p.device)
    return torch.mean((p == r).to(_F64))


def r2_score(y, y_hat):
    """``1 - SS_res / SS_tot``."""
    y = as_tensor(y)
    y_hat = torch.as_tensor(y_hat, device=y.device)
    ss_tot = torch.sum((y - torch.mean(y)) ** 2)
    ss_res = torch.sum((y - y_hat) ** 2)
    return 1.0 - ss_res / ss_tot


def regression_metrics(predictions, ref_predictions):
    """``(mean_abs_error, mean_squared_error, median_abs_error)``, the
    median of an even count the mean of the middle two."""
    p = as_tensor(predictions).to(_F64)
    r = torch.as_tensor(ref_predictions, device=p.device).to(_F64)
    err = p - r
    abs_err = err.abs()
    s = torch.sort(abs_err).values
    n = s.shape[0]
    medae = s[n // 2] if n % 2 == 1 else 0.5 * (s[n // 2 - 1] + s[n // 2])
    return torch.mean(abs_err), torch.mean(err * err), medae
