"""Isotropic Gaussian clusters (counterpart of
``raft_tpu/random/make_blobs.py``), on the handle's device."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# the module, not its names: core.resources imports this package
from raft_tpu_torch.core import resources
from raft_tpu_torch.random.rng_state import RngState


def make_blobs(res, state: RngState, n_rows: int, n_cols: int,
               n_clusters: int = 5, cluster_std: float = 1.0,
               center_box: Tuple[float, float] = (-10.0, 10.0),
               centers: Optional[torch.Tensor] = None,
               shuffle: bool = True, dtype=torch.float32):
    """``(X [n_rows, n_cols], labels [n_rows] int32, centers)``.

    Centers are uniform in ``center_box`` unless given (then
    ``n_clusters`` is their count); labels go round-robin, ``i %
    n_clusters``, then are shuffled; ``X = centers[labels] + N(0,
    cluster_std)``. One generator for the call, as the reference takes
    one key."""
    dev = resources.default_resources(res).device
    g = state.next_key(dev)
    if centers is None:
        lo, hi = center_box
        centers = torch.empty((int(n_clusters), int(n_cols)), dtype=dtype,
                              device=dev).uniform_(lo, hi, generator=g)
    else:
        centers = torch.as_tensor(centers, dtype=dtype, device=dev)
        n_clusters = centers.shape[0]
    labels = torch.arange(int(n_rows), dtype=torch.int32,
                          device=dev) % int(n_clusters)
    if shuffle:
        labels = labels[torch.randperm(int(n_rows), generator=g,
                                       device=dev)]
    X = torch.randn((int(n_rows), int(n_cols)), generator=g, dtype=dtype,
                    device=dev)
    X.mul_(cluster_std).add_(centers[labels])
    return X, labels, centers
