"""Multi-variable Gaussian sampling (counterpart of
``raft_tpu/random/multi_variable_gaussian.py``).

The covariance's factor F (F·Fᵀ = cov) comes from one of the reference's
three decomposers: Cholesky (``torch.linalg.cholesky``, cuSOLVER's potrf
on the card), the symmetric eigendecomposition (``linalg.eig_dc``), or
the R factor of the QR of that root (``linalg.qr_get_qr``). The draws
``z @ Fᵀ`` are taken at the precision tier in effect (``linalg.blas``:
'high' is bf16x3, never TF32).
"""

from __future__ import annotations

import enum

import torch

# the module, not its names: core.resources imports this package
from raft_tpu_torch.core import resources
from raft_tpu_torch.random.rng_state import RngState


class Decomposer(enum.Enum):
    CHOLESKY = "chol_decomp"
    JACOBI = "jacobi"      # symmetric eigendecomposition
    QR = "qr"


def multi_variable_gaussian(res, state: RngState, mean, cov, n_samples: int,
                            method: Decomposer = Decomposer.CHOLESKY,
                            dtype=torch.float32):
    """``n_samples`` draws of N(mean, cov): [n_samples, dim]."""
    from raft_tpu_torch.linalg.blas import _product
    from raft_tpu_torch.linalg.eig import eig_dc
    from raft_tpu_torch.linalg.qr import qr_get_qr
    from raft_tpu_torch.util.precision import current_mode, scope

    dev = resources.default_resources(res).device
    f32 = torch.float32
    mean = torch.as_tensor(mean, device=dev).to(f32)
    cov = torch.as_tensor(cov, device=dev).to(f32)
    dim = mean.shape[0]
    if method == Decomposer.CHOLESKY:
        factor = torch.linalg.cholesky(cov)
    elif method in (Decomposer.JACOBI, Decomposer.QR):
        w, v = eig_dc(res, cov)
        factor = v * torch.sqrt(torch.clamp_min(w, 0.0))[None, :]
        if method == Decomposer.QR:
            # any F with F Fᵀ = cov: the R of root.T = QR gives R.T
            factor = qr_get_qr(res, factor.T)[1].T
    else:
        raise ValueError(f"unknown decomposer {method}")
    z = torch.randn((int(n_samples), dim), generator=state.next_key(dev),
                    dtype=f32, device=dev)
    with scope():
        out = _product(z, factor, False, True, f32, current_mode())
    return (mean[None, :] + out).to(dtype)
