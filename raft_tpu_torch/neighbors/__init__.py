"""Nearest-neighbour search of the port: brute-force kNN on one device."""

from raft_tpu_torch.neighbors.brute_force import knn, knn_plan  # noqa: F401
