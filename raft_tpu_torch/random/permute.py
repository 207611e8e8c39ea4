"""Random permutations (counterpart of ``raft_tpu/random/permute.py``):
``torch.randperm`` with the call's generator, on the handle's device."""

from __future__ import annotations

import torch

# the module, not its names: core.resources imports this package
from raft_tpu_torch.core import resources
from raft_tpu_torch.random.rng_state import RngState


def permute(res, state: RngState, n: int, dtype=torch.int32):
    """A random permutation of [0, n)."""
    dev = resources.default_resources(res).device
    return torch.randperm(int(n), generator=state.next_key(dev),
                          device=dev).to(dtype)


def permute_rows(res, state: RngState, X):
    """``(X[perm], perm)``: a row-permuted copy of ``X`` and the int32
    permutation. ``X`` runs on its device, an array on the handle's."""
    X = resources.as_tensor(X, res)
    perm = torch.randperm(X.shape[0], generator=state.next_key(X.device),
                          device=X.device)
    return X[perm], perm.to(torch.int32)
