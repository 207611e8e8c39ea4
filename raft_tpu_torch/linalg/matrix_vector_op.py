"""Broadcast a vector (or two) along the rows or columns of a matrix
(counterpart of ``raft_tpu/linalg/matrix_vector_op.py``). ALONG_ROWS
broadcasts a length-n_cols vector across every row; ALONG_COLUMNS a
length-n_rows vector down every column."""

from __future__ import annotations

from typing import Callable

from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.linalg.reduce import ALONG_COLUMNS, ALONG_ROWS


def matrix_vector_op(res, matrix, vec, op: Callable,
                     apply: str = ALONG_ROWS, vec2=None):
    """out[i, j] = op(m[i, j], v[j] (, v2[j])) for ALONG_ROWS."""
    m = as_tensor(matrix, res)
    v = as_tensor(vec, res)
    v2 = None if vec2 is None else as_tensor(vec2, res)
    if apply == ALONG_ROWS:
        bv = v[None, :]
        bv2 = None if v2 is None else v2[None, :]
    elif apply == ALONG_COLUMNS:
        bv = v[:, None]
        bv2 = None if v2 is None else v2[:, None]
    else:
        raise ValueError(f"bad apply {apply}")
    if vec2 is None:
        return op(m, bv)
    return op(m, bv, bv2)
