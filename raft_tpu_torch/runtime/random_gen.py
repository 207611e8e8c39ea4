"""raft::runtime::random parity (counterpart of
``raft_tpu/runtime/random_gen.py``; ref:
raft_runtime/random/rmat_rectangular_generator.hpp
``rmat_rectangular_gen``, instantiated for {int, int64_t} x {float,
double} theta).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.random.rmat import rmat_rectangular_gen as _rmat
from raft_tpu_torch.random.rng_state import RngState

_INDEX_TYPES = {np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64}


def _index_dtype(out_dtype) -> torch.dtype:
    if isinstance(out_dtype, torch.dtype):
        if out_dtype in _INDEX_TYPES.values():
            return out_dtype
    else:
        try:
            found = _INDEX_TYPES.get(np.dtype(out_dtype))
        except TypeError:
            found = None
        if found is not None:
            return found
    raise TypeError(
        f"index dtype must be int32 or int64, got {out_dtype} (the "
        f"reference instantiates exactly these)")


def rmat_rectangular_gen(handle, state: RngState, theta, r_scale: int,
                         c_scale: int, n_edges: int,
                         out_dtype=torch.int32
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host-callable R-MAT edge generator over a per-level theta table
    (ref call shape: rmat_rectangular_gen(handle, rng, theta, out,
    r_scale, c_scale); the out buffer becomes a returned (src, dst)) on
    the handle's device, ``cuda:0`` by default. ``out_dtype``: int32 or
    int64, as a torch or numpy dtype."""
    dtype = _index_dtype(out_dtype)
    if theta is not None:
        theta = torch.as_tensor(np.asarray(theta, np.float32))
    return _rmat(handle, state, r_scale=r_scale, c_scale=c_scale,
                 n_edges=n_edges, theta=theta, dtype=dtype)
