"""Pairwise distances of the port."""

from raft_tpu_torch.distance.pairwise import (  # noqa: F401
    DistanceType,
    fused_l2_nn_argmin,
    pairwise_distance,
)
