"""Nearest-neighbour search of the port: brute-force kNN on one device
and over the ranks of a mesh, the inverted-file indexes (IVF-Flat,
IVF-PQ, and IVF-Flat sharded over a mesh), and the streaming IVF-Flat
index with its journal, compactor and scrubber."""

from raft_tpu_torch.neighbors import ivf_flat  # noqa: F401
from raft_tpu_torch.neighbors import ivf_mnmg  # noqa: F401
from raft_tpu_torch.neighbors import ivf_pq  # noqa: F401
from raft_tpu_torch.neighbors import scrub  # noqa: F401
from raft_tpu_torch.neighbors import streaming  # noqa: F401
from raft_tpu_torch.neighbors.brute_force import (  # noqa: F401
    knn, knn_mnmg, knn_plan)
from raft_tpu_torch.neighbors.ivf_flat import IvfFlatIndex  # noqa: F401
from raft_tpu_torch.neighbors.ivf_mnmg import (  # noqa: F401
    IvfMnmgIndex, build_mnmg, rebalance_mnmg, search_mnmg, shrink_mnmg)
from raft_tpu_torch.neighbors.ivf_pq import IvfPqIndex  # noqa: F401
from raft_tpu_torch.neighbors.scrub import Scrubber, ScrubReport  # noqa: F401
from raft_tpu_torch.neighbors.streaming import (  # noqa: F401
    Compactor, DriftGauge, MutationLog, RecoveryError, ShardCorruptError,
    StreamingError, StreamingIndex, StreamingMnmg, TermFencedError,
    WalGapError, stream_build)

__all__ = ["knn", "knn_mnmg", "knn_plan", "ivf_flat", "IvfFlatIndex",
           "ivf_pq", "IvfPqIndex", "ivf_mnmg", "IvfMnmgIndex", "build_mnmg",
           "search_mnmg", "shrink_mnmg", "rebalance_mnmg",
           "streaming", "StreamingIndex", "StreamingMnmg", "stream_build",
           "Compactor", "DriftGauge", "MutationLog", "StreamingError",
           "RecoveryError", "WalGapError", "TermFencedError",
           "scrub", "Scrubber", "ScrubReport", "ShardCorruptError"]
