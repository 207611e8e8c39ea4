"""Linear-model datasets (counterpart of
``raft_tpu/random/make_regression.py``).

X is Gaussian (or of low effective rank, with the reference's bell-shaped
singular profile, from two QR factors), ``y = X·w + bias + noise`` with
``n_informative`` nonzero rows of ``w`` uniform in [0, 100). The products
run at the precision tier in effect (``linalg.blas``), never TF32.
"""

from __future__ import annotations

from typing import Optional

import torch

# the module, not its names: core.resources imports this package
from raft_tpu_torch.core import resources
from raft_tpu_torch.random.rng_state import RngState


def make_regression(res, state: RngState, n_rows: int, n_cols: int,
                    n_informative: Optional[int] = None, n_targets: int = 1,
                    bias: float = 0.0, effective_rank: Optional[int] = None,
                    tail_strength: float = 0.5, noise: float = 0.0,
                    shuffle: bool = True, dtype=torch.float32):
    """``(X [n_rows, n_cols], y [n_rows, n_targets], w [n_cols,
    n_targets])``."""
    from raft_tpu_torch.linalg.blas import _product
    from raft_tpu_torch.util.precision import current_mode, scope

    dev = resources.default_resources(res).device
    n_informative = n_cols if n_informative is None else n_informative
    g = state.next_key(dev)
    f32 = torch.float32
    ct = torch.float64 if dtype == torch.float64 else f32
    with scope():
        tier = current_mode()
        if effective_rank is None:
            X = torch.randn((n_rows, n_cols), generator=g, dtype=dtype,
                            device=dev)
        else:
            rank = min(n_rows, n_cols)
            u = torch.linalg.qr(torch.randn((n_rows, rank), generator=g,
                                            dtype=f32, device=dev)).Q
            v = torch.linalg.qr(torch.randn((n_cols, rank), generator=g,
                                            dtype=f32, device=dev)).Q
            sing = torch.arange(rank, dtype=f32, device=dev) / effective_rank
            s = ((1 - tail_strength) * torch.exp(-(sing ** 2))
                 + tail_strength * torch.exp(-0.1 * sing))
            X = _product(u * s[None, :], v, False, True, f32, tier).to(dtype)
        w = torch.zeros((n_cols, n_targets), dtype=dtype, device=dev)
        w[:n_informative] = 100.0 * torch.rand(
            (n_informative, n_targets), generator=g, dtype=dtype, device=dev)
        y = _product(X, w, False, False, ct, tier).to(dtype) + bias
    if noise > 0.0:
        y = y + noise * torch.randn(y.shape, generator=g, dtype=dtype,
                                    device=dev)
    if shuffle:
        row_perm = torch.randperm(n_rows, generator=g, device=dev)
        col_perm = torch.randperm(n_cols, generator=g, device=dev)
        X = X[row_perm][:, col_perm]
        w = w[col_perm]
        y = y[row_perm]
    return X, y, w
