"""Runtime layer of the port (counterpart of ``raft_tpu/runtime``):

- :mod:`~raft_tpu_torch.runtime.limits`: deadlines, work budgets,
  breakers, rate budgets and the chunk-seconds model;
- :mod:`~raft_tpu_torch.runtime.compiled_driver`: solver inner loops as
  captured CUDA-graph chunks, one host read a chunk;
- :mod:`~raft_tpu_torch.runtime.solver`,
  :mod:`~raft_tpu_torch.runtime.random_gen`: the instantiated entry
  points the reference exposes from libraft.so (``lanczos_solver``,
  ``rmat_rectangular_gen``) with their {int32, int64} x {float32,
  float64} matrix.

The reference's ahead-of-time export (``runtime.aot``) is ROADMAP.md
queue A item 13b.
"""

from raft_tpu_torch.runtime import limits, random_gen, solver
from raft_tpu_torch.runtime import compiled_driver

__all__ = ["solver", "random_gen", "limits", "compiled_driver"]
