"""Matrix primitives of the port: batched top-k selection and per-row
argmin/argmax."""

from raft_tpu_torch.matrix.epilogue import argmax, argmin  # noqa: F401
from raft_tpu_torch.matrix.select_k import SelectAlgo, select_k  # noqa: F401
