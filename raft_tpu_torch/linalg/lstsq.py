"""Least squares (counterpart of ``raft_tpu/linalg/lstsq.py``): the SVD,
eigendecomposition and QR routes on ``torch.linalg`` (cuSOLVER on the
card), with the reference's SVD cutoff and its multi-RHS shapes (``b``
[m] or [m, r])."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.util.input_validation import expect_2d, expect_finite
from raft_tpu_torch.util.precision import with_matmul_precision


def _scale_rows(x, s):
    """Row-scale that is correct for both 1-D (single-RHS) and 2-D b."""
    return x * s if x.ndim == 1 else x * s[:, None]


def _validate(op: str, A, b):
    """Entry checks shared by the variants: shapes always, values only
    under a guard mode that asks for them."""
    expect_2d(A, name=f"{op}: A")
    if b.shape[0] != A.shape[0]:
        raise ValueError(f"{op}: b rows {b.shape[0]} != A rows "
                         f"{A.shape[0]}")
    expect_finite(A, name=f"{op}: A")
    expect_finite(b, name=f"{op}: b")


def _operands(res, op: str, A, b):
    A = as_tensor(A, res)
    b = as_tensor(b, res).to(A.dtype)
    _validate(op, A, b)
    return A, b


@with_matmul_precision
def lstsq_svd_qr(res, A, b):
    """Minimum-norm solution by the SVD: singular values at most
    ``eps · max(m, n) · s[0]`` are dropped."""
    A, b = _operands(res, "linalg.lstsq_svd_qr", A, b)
    u, s, vh = torch.linalg.svd(A, full_matrices=False)
    cutoff = torch.finfo(A.dtype).eps * max(A.shape) * s[0]
    s_inv = torch.where(s > cutoff, 1.0 / s, torch.zeros_like(s))
    return vh.T @ _scale_rows(u.T @ b, s_inv)


@with_matmul_precision
def lstsq_svd_jacobi(res, A, b):
    """The Jacobi-SVD spelling: the same SVD route."""
    return lstsq_svd_qr(res, A, b)


@with_matmul_precision
def lstsq_eig(res, A, b):
    """Normal equations through the eigendecomposition of AᵀA."""
    A, b = _operands(res, "linalg.lstsq_eig", A, b)
    w, v = torch.linalg.eigh(A.T @ A)
    cutoff = torch.finfo(A.dtype).eps * max(A.shape) * torch.max(
        torch.abs(w))
    w_inv = torch.where(torch.abs(w) > cutoff, 1.0 / w, torch.zeros_like(w))
    return v @ _scale_rows(v.T @ (A.T @ b), w_inv)


@with_matmul_precision
def lstsq_qr(res, A, b):
    """QR, then the triangular solve R x = Qᵀ b."""
    A, b = _operands(res, "linalg.lstsq_qr", A, b)
    q, r = torch.linalg.qr(A, mode="reduced")
    rhs = q.T @ b
    x = torch.linalg.solve_triangular(r, rhs if rhs.ndim == 2
                                      else rhs[:, None], upper=True)
    return x if rhs.ndim == 2 else x[:, 0]
