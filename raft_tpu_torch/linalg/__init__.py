"""Linear algebra of the port: the contraction engine so far."""

from raft_tpu_torch.linalg.contractions import (  # noqa: F401
    fused_argmin_pallas,
    fused_l2_argmin_pallas,
    fused_lloyd_pallas,
    fused_lloyd_prepared,
    lloyd_prepare,
    pairwise_l2_pallas,
    pairwise_pallas,
)
