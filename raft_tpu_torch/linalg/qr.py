"""QR factorization (counterpart of ``raft_tpu/linalg/qr.py``):
``torch.linalg.qr``, cuSOLVER's geqrf/orgqr on the card."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.resources import as_tensor


def qr_get_q(res, matrix):
    """Q factor only (reduced)."""
    return torch.linalg.qr(as_tensor(matrix, res), mode="reduced").Q


def qr_get_qr(res, matrix):
    """(Q, R), reduced."""
    q, r = torch.linalg.qr(as_tensor(matrix, res), mode="reduced")
    return q, r
