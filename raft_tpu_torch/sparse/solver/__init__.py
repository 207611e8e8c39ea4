"""Sparse solvers (counterpart of ``raft_tpu/sparse/solver``): thick-restart
Lanczos ``eigsh`` and the Borůvka minimum spanning forest ``mst``."""

from .lanczos import (LanczosConfig, eigsh,  # noqa: F401
                      eigsh_mnmg, lanczos_compute_eigenpairs)
from .mst import GraphCOO, mst  # noqa: F401
