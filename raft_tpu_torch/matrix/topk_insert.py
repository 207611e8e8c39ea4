"""Sorted-insertion top-k over a materialised input — the
``insert_select`` path of matrix/select_k (counterpart of
``raft_tpu/matrix/topk_insert.py``).

CUDA kernel: ``csrc/topk_insert.cu`` (the insertion drain of
``raft_tpu/matrix/epilogue.py:insert_drain`` over a [rows, len] matrix),
beside its plain version :func:`_insert_plain`. The degenerate-row check
and its re-answer through the direct select run on the tensors' device
after the kernel, as in the reference: they are the function's
contract, not a fallback from the kernel.
"""

from __future__ import annotations

import torch

from raft_tpu_torch import kernels
from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.matrix import _topk_order
from raft_tpu_torch.matrix.epilogue import (MAX_K, insert_drain_plain,
                                            resolve_tn_sw)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def supports(dtype, k: int) -> bool:
    """f32/bf16/f16 only (the drain compares in f32, exact for these),
    k within the 256-wide best."""
    return dtype in _DTYPE_CODE and 1 <= k <= MAX_K


def _insert_plain(v: torch.Tensor, k: int, select_min: bool):
    """The drain over ``v`` (or ``-v`` for select_max): ``(vals f32
    [rows, k], idx int32 [rows, k])``, best-first, empty slots
    ``(+inf, 0)``."""
    d = v.to(torch.float32)
    return insert_drain_plain(d if select_min else -d, k)


def _topk_insert(v: torch.Tensor, k: int, select_min: bool):
    """The drain: csrc/topk_insert.cu on CUDA, the plain version on the
    CPU."""
    if v.dim() != 2 or v.dtype not in _DTYPE_CODE or v.stride(1) != 1:
        raise ValueError("expected 2-D f32/bf16/f16 values with unit column "
                         "stride")
    rows, n = v.shape
    if not 1 <= k <= min(n, MAX_K):
        raise ValueError(f"need 1 <= k <= min({n}, {MAX_K}), got {k}")
    if v.device.type == "cpu":
        return _insert_plain(v, k, select_min)
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    vals = torch.empty((rows, k), dtype=torch.float32, device=v.device)
    idx = torch.empty((rows, k), dtype=torch.int32, device=v.device)
    kernels.launch("topk_insert", v.device, _DTYPE_CODE[v.dtype],
                   int(select_min), v.data_ptr(), v.stride(0), rows, n, k,
                   vals.data_ptr(), idx.data_ptr())
    return vals, idx


def insert_select(values, k: int, select_min: bool = True,
                  tm: int = 256, tn: int = 2048, sw: int = 256):
    """Top-k of each row by bound-gated sorted insertion.

    Returns ``(vals [m, k], idx [m, k] int32)``, best-first, in the
    input's dtype. NaNs never insert; when any row has fewer than k
    candidates below the drain's +inf sentinel, every row is re-answered
    through the direct select (index parity with it on degenerate data).
    ``tm``, ``tn`` and ``sw`` are the reference's TPU tile knobs: they
    are validated as there and choose nothing here. A non-tensor input
    goes to ``cuda:0``. CUDA kernel: ``csrc/topk_insert.cu``."""
    v = as_tensor(values)
    m, n = v.shape
    if not supports(v.dtype, k):
        raise ValueError(f"insert_select: unsupported {v.dtype}/k={k}")
    resolve_tn_sw(tn, sw, n)
    vals, idx = _topk_insert(v.contiguous(), k, select_min)
    if bool(torch.any(torch.isinf(vals) & (vals > 0))):
        # the direct select of select_k
        dv, di = _topk_order.topk(v, k, largest=not select_min)
        return dv, di.to(torch.int32)
    return (vals if select_min else -vals).to(v.dtype), idx
