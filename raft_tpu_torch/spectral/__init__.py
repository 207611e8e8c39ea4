"""Spectral graph analysis (counterpart of ``raft_tpu/spectral``): the
partition and modularity drivers and their quality analyzers, over the
port's sparse layer, Lanczos solver and k-means."""

from raft_tpu_torch.spectral.analyzers import (  # noqa: F401
    analyze_modularity,
    analyze_partition,
)
from raft_tpu_torch.spectral.partition import (  # noqa: F401
    modularity_maximization,
    partition,
)
