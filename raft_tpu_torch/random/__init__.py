"""Random state of the port."""

from raft_tpu_torch.random.rng_state import RngState  # noqa: F401
