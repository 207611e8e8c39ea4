"""Row and column norms and normalization (counterpart of
``raft_tpu/linalg/norm.py``)."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.linalg.reduce import ALONG_COLUMNS, ALONG_ROWS, _axis

L1Norm = "l1"
L2Norm = "l2"
LinfNorm = "linf"


def norm(res, data, norm_type: str = L2Norm, apply: str = ALONG_ROWS,
         sqrt: bool = False):
    """Per-row or per-column norm. L2 is the *squared* norm unless
    ``sqrt=True``, as the reference's rowNorm."""
    data = as_tensor(data, res)
    axis = _axis(apply)
    if norm_type == L1Norm:
        out = torch.sum(torch.abs(data), dim=axis)
    elif norm_type == L2Norm:
        out = torch.sum(data * data, dim=axis)
        if sqrt:
            out = torch.sqrt(out)
    elif norm_type == LinfNorm:
        out = torch.amax(torch.abs(data), dim=axis)
    else:
        raise ValueError(f"unknown norm {norm_type}")
    return out


def row_norm(res, data, norm_type: str = L2Norm, sqrt: bool = False):
    return norm(res, data, norm_type, ALONG_ROWS, sqrt)


def col_norm(res, data, norm_type: str = L2Norm, sqrt: bool = False):
    return norm(res, data, norm_type, ALONG_COLUMNS, sqrt)


def normalize(res, data, norm_type: str = L2Norm, eps: float = 1e-8):
    """Row-normalize; a row whose norm is at most ``eps`` becomes zeros,
    and ``eps`` floors the divide."""
    data = as_tensor(data, res)
    if norm_type == L2Norm:
        n = torch.sqrt(torch.sum(data * data, dim=1, keepdim=True))
    elif norm_type == L1Norm:
        n = torch.sum(torch.abs(data), dim=1, keepdim=True)
    elif norm_type == LinfNorm:
        n = torch.amax(torch.abs(data), dim=1, keepdim=True)
    else:
        raise ValueError(f"unknown norm {norm_type}")
    return torch.where(n > eps, data / torch.clamp_min(n, eps),
                       torch.zeros_like(data))
