"""SVD and randomized SVD (counterpart of ``raft_tpu/linalg/svd.py``).

``svd_qr`` is ``torch.linalg.svd`` (cuSOLVER on the card) and returns V,
not Vᵀ; ``svd_eig`` takes the Gram matrix's ``eigh``; ``svd_jacobi`` is
an alias of ``svd_qr``, as in the reference. The randomized SVD keeps
the reference's range finder (a Gaussian sketch, power iterations with
QR re-orthonormalization, a small exact SVD in the subspace). Its sketch
comes from ``RngState.next_key`` on the matrix's device: the
stream is torch's, not JAX's (ROADMAP.md, queue C "RNG streams
differ"), so the two packages agree on the singular values, not bit for
bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.random.rng_state import RngState
from raft_tpu_torch.util.precision import with_matmul_precision


@with_matmul_precision
def svd_qr(res, matrix, full_matrices: bool = False):
    """(U, S, V) with V's columns the right singular vectors: cuSOLVER's
    QR-iteration SVD (gesvd) on the card, as the reference's svdQR names
    it (torch's default there, gesvdj, keeps f32 singular values to
    about 2e-4 of the largest at BASELINE config 2's shape: chip_smoke.py's
    config2 line)."""
    a = as_tensor(matrix, res)
    u, s, vh = torch.linalg.svd(
        a, full_matrices=full_matrices,
        driver="gesvd" if a.device.type == "cuda" else None)
    return u, s, vh.mT


@with_matmul_precision
def svd_eig(res, matrix):
    """SVD through the eigendecomposition of the Gram matrix AᵀA (the
    route for tall matrices): singular values descending, U = A V / S
    with S floored at the dtype's ``tiny``."""
    a = as_tensor(matrix, res)
    w, v = torch.linalg.eigh(a.T @ a)          # ascending
    w = torch.flip(w, (0,))
    v = torch.flip(v, (1,))
    s = torch.sqrt(torch.clamp_min(w, 0.0))
    u = (a @ v) / torch.clamp_min(s[None, :], torch.finfo(a.dtype).tiny)
    return u, s, v


@with_matmul_precision
def svd_jacobi(res, matrix, tol: float = 1e-7, sweeps: int = 15):
    """The Jacobi-SVD spelling: ``svd_qr``."""
    return svd_qr(res, matrix)


@with_matmul_precision
def svd_reconstruction(res, u, s, v):
    """A ≈ U·diag(S)·Vᵀ."""
    u, s, v = (as_tensor(t, res) for t in (u, s, v))
    return (u * s[None, :]) @ v.T


@with_matmul_precision
def evaluate_svd_by_reconstruction(res, matrix, u, s, v,
                                   tol: float = 1e-3) -> bool:
    """||A - U S Vᵀ||_F / ||A||_F < tol."""
    a = as_tensor(matrix, res)
    recon = svd_reconstruction(res, u, s, v)
    err = torch.linalg.norm(a - recon) / torch.clamp_min(
        torch.linalg.norm(a), 1e-30)
    return bool(err < tol)


@with_matmul_precision
def rsvd_fixed_rank(res, matrix, k: int, p: int = 10, n_iter: int = 2,
                    state: Optional[RngState] = None,
                    use_bbt: Optional[bool] = None):
    """Randomized SVD of rank ``k`` with oversampling ``p``: a Gaussian
    sketch, ``n_iter`` power iterations with QR re-orthonormalization,
    then the exact SVD of the [k + p, n] projection."""
    a = as_tensor(matrix, res)
    m, n = a.shape
    state = state or RngState(seed=0)
    ell = min(k + p, min(m, n))
    omega = torch.randn((n, ell), generator=state.next_key(a.device),
                        dtype=a.dtype, device=a.device)
    q = torch.linalg.qr(a @ omega).Q
    for _ in range(n_iter):
        z = torch.linalg.qr(a.T @ q).Q
        q = torch.linalg.qr(a @ z).Q
    ub, s, vh = torch.linalg.svd(q.T @ a, full_matrices=False)
    u = q @ ub
    return u[:, :k], s[:k], vh[:k].T


@with_matmul_precision
def rsvd_perc(res, matrix, perc: float, p: int = 10, n_iter: int = 2,
              state: Optional[RngState] = None):
    """Rank chosen as a fraction of min(m, n)."""
    a = as_tensor(matrix, res)
    m, n = a.shape
    k = max(1, int(perc * min(m, n)))
    return rsvd_fixed_rank(res, a, k, p=p, n_iter=n_iter, state=state)


randomized_svd = rsvd_fixed_rank
