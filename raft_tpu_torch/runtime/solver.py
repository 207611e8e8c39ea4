"""raft::runtime::solver parity (counterpart of
``raft_tpu/runtime/solver.py``; ref: raft_runtime/solver/lanczos.hpp
``lanczos_solver``, instantiated for {int, int64_t} x {float, double}).

The instantiation matrix is explicit: index dtype in {int32, int64},
value dtype in {float32, float64}; anything else is rejected at the
boundary, as the reference's fixed symbol set rejects it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import resources
from raft_tpu_torch.core.sparse_types import CSRMatrix
from raft_tpu_torch.sparse.solver.lanczos import (LanczosConfig,
                                                  lanczos_compute_eigenpairs)

_INDEX_TYPES = (torch.int32, torch.int64)
_VALUE_TYPES = (torch.float32, torch.float64)


def _buffer(a, dev) -> torch.Tensor:
    """A tensor stays on its device; anything else goes to ``dev``."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a), device=dev)


def lanczos_solver(handle, config: LanczosConfig, rows, cols, vals,
                   v0=None, n: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host-callable thick-restart Lanczos over raw CSR buffers (ref
    signature: lanczos_solver(res, config, rows, cols, vals, v0,
    eigenvalues, eigenvectors); the outputs are returned).

    ``rows`` is the CSR indptr (len n+1), ``cols``/``vals`` the column
    indices and values. Tensors stay on their device; arrays go to the
    handle's (``cuda:0`` by default)."""
    dev = None
    if not all(isinstance(a, torch.Tensor) for a in (rows, cols, vals)):
        dev = resources.default_resources(handle).device
    rows, cols, vals = (_buffer(a, dev) for a in (rows, cols, vals))
    if rows.dtype not in _INDEX_TYPES or cols.dtype not in _INDEX_TYPES:
        raise TypeError(
            f"index dtype must be one of {_INDEX_TYPES}, got "
            f"{rows.dtype}/{cols.dtype} (the reference instantiates "
            f"exactly these, lanczos_solver.cuh:10-24)")
    if vals.dtype not in _VALUE_TYPES:
        raise TypeError(
            f"value dtype must be one of {_VALUE_TYPES}, got {vals.dtype}")
    nn = int(n if n is not None else rows.shape[0] - 1)
    csr = CSRMatrix(rows, cols, vals, (nn, nn))
    return lanczos_compute_eigenpairs(handle, csr, config, v0)
