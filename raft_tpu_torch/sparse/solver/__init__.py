"""Sparse solvers: thick-restart Lanczos ``eigsh`` (counterpart of
``raft_tpu/sparse/solver``; the MST solver is not ported yet)."""

from .lanczos import (LanczosConfig, eigsh,  # noqa: F401
                      eigsh_mnmg, lanczos_compute_eigenpairs)
