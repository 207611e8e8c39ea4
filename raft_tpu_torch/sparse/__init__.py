"""Sparse primitives (counterpart of ``raft_tpu/sparse``): CSR/COO types,
conversions, structural ops, SpMV/SpMM on the card, the thick-restart
Lanczos eigensolver and the Borůvka MST.

Not ported yet (ROADMAP.md, queue A item 11): ``ELLMatrix``/``ell``,
``sparse/matrix.py`` and ``sparse/csr.py`` (``weak_cc``).
"""

from raft_tpu_torch.core.sparse_types import COOMatrix, CSRMatrix  # noqa: F401

from . import convert, grid_spmv, linalg, op  # noqa: F401
from raft_tpu_torch.sparse.grid_spmv import GridSpMV  # noqa: F401
from . import solver  # noqa: F401
