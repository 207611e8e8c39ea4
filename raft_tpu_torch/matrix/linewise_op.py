"""Row and column broadcast of vectors over a matrix (counterpart of
``raft_tpu/matrix/linewise_op.py``): one broadcast torch expression."""

from __future__ import annotations

from typing import Callable

import torch

from raft_tpu_torch.core.resources import as_tensor


def linewise_op(res, matrix, op: Callable, along_lines: bool, *vecs):
    """``op(m, v1, v2, ...)`` with each vector broadcast along the
    matrix's lines: ``along_lines=True`` takes vectors of length n_cols
    (indexed by column), ``False`` of length n_rows (indexed by row)."""
    m = as_tensor(matrix, res)
    vs = [torch.as_tensor(v, device=m.device) for v in vecs]
    bvecs = [v[None, :] if along_lines else v[:, None] for v in vs]
    return op(m, *bvecs)
