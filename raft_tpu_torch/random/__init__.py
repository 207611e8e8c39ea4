"""Random state and generators of the port."""

from raft_tpu_torch.random.rng_state import RngState  # noqa: F401
from raft_tpu_torch.random.rmat import rmat_rectangular_gen  # noqa: F401
