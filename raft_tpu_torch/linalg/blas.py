"""BLAS-level ops: gemm, gemv, axpy, dot, transpose (counterpart of
``raft_tpu/linalg/blas.py``).

gemm keeps the precision tiers of ``util.precision`` on the card:

- ``'highest'``: cuBLAS f32 with TF32 off (:func:`precision.scope` pins
  it off for the call);
- ``'high'``: bf16x3. Each f32 operand is split into bf16 halves by
  ``contractions._split_hi_lo`` and the product is
  ``hi·hi + hi·lo + lo·hi``, each a bf16 product with an f32 result;
- ``'default'``: one bf16 pass with an f32 result.

A bf16 product with an f32 result is ``torch.bmm`` with
``out_dtype=torch.float32`` on the card (cuBLAS, f32 accumulation) over
chunks of the depth (``_K_CHUNK``: the tensor cores' accumulator
truncates), summed in f32; on the CPU, where those ops have no kernel, it
is the f32 product of the bf16 values, which are exact in f32. No tier
runs in TF32. f64 operands
accumulate in f64 (``compute_type``).

Not ported yet (ROADMAP.md, queue A item 13b): the ``runtime.limits``
work-budget admission (with no budget active the reference skips it
too) and the guard modes 'check' and 'recover', which raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.guards import resolve_guard_mode
from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.linalg.contractions import _split_hi_lo
from raft_tpu_torch.util.precision import (current_mode, resolve,
                                           with_matmul_precision)


# The depth of one summation on the tensor cores in a bf16 product with
# an f32 result. Hopper's tensor cores add each 16-deep step into the
# f32 accumulator by truncation, not rounding, so over a deep sum of
# like-signed products the loss grows with the steps (chip_smoke.py's
# config2 line gives the gram gemm's bf16x3 error at K = 16,384 in one
# call beside the chunked one). The product is therefore taken in
# chunks of this depth, as cuBLAS batches, whose f32 results are summed
# with rounding: the loss stays at a chunk's 64 steps.
_K_CHUNK = 1024
# The most f32 elements one batch of chunk products may hold.
_BATCH_ELEMS = 1 << 26


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 with f32 accumulation and an f32 result: ``a [m, k]
    @ b [k, n]``, or ``a [batch, m, k] @ b [batch, k, n]``."""
    if a.device.type != "cuda":
        return a.float() @ b.float()
    f32 = torch.float32
    mm = torch.mm if a.dim() == 2 else torch.bmm
    a3, b3 = (a[None], b[None]) if a.dim() == 2 else (a, b)
    (nb, m, k), n = a3.shape, b3.shape[2]
    nc, tail = divmod(k, _K_CHUNK)
    out = (mm(a[..., k - tail:], b[..., k - tail:, :], out_dtype=f32)
           if tail or not nc else None)
    # the chunks as one [chunk, batch, ...] view, taken ``per`` at a time
    sa, sb = a3.stride(), b3.stride()
    ab = a3.as_strided((nc, nb, m, _K_CHUNK),
                       (_K_CHUNK * sa[2], sa[0], sa[1], sa[2]))
    bb = b3.as_strided((nc, nb, _K_CHUNK, n),
                       (_K_CHUNK * sb[1], sb[0], sb[1], sb[2]))
    per = max(1, _BATCH_ELEMS // max(nb * m * n, 1))
    for c0 in range(0, nc, per):
        ac, bc = ab[c0:c0 + per], bb[c0:c0 + per]
        part = torch.bmm(ac.reshape(-1, m, _K_CHUNK),
                         bc.reshape(-1, _K_CHUNK, n), out_dtype=f32)
        part = part.reshape((ac.shape[0],) + a.shape[:-1] + (n,)).sum(0)
        out = part if out is None else out + part
    return out


def _product(A, B, trans_a: bool, trans_b: bool, compute_type,
             tier: str) -> torch.Tensor:
    """op(A)·op(B) in ``compute_type`` at ``tier``; ``A`` and ``B`` are
    matrices or batches of them (``[batch, m, k]``, ``[batch, k, n]``),
    and ``op`` transposes the last two dimensions."""

    def op(a, b):
        return (a.transpose(-1, -2) if trans_a else a,
                b.transpose(-1, -2) if trans_b else b)

    if compute_type == torch.float64:
        return torch.matmul(*op(A.to(torch.float64), B.to(torch.float64)))
    if A.dtype == B.dtype == torch.bfloat16:
        return _mm_f32(*op(A, B))
    if tier == "highest":
        return torch.matmul(*op(A.to(torch.float32), B.to(torch.float32)))
    if tier == "default":
        return _mm_f32(*op(A.to(torch.bfloat16), B.to(torch.bfloat16)))
    a_hi, a_lo = _split_hi_lo(A.to(torch.float32))
    b_hi, b_lo = ((a_hi, a_lo) if B is A
                  else _split_hi_lo(B.to(torch.float32)))
    a_hi, b_hi = op(a_hi, b_hi)
    a_lo, b_lo = op(a_lo, b_lo)
    return _mm_f32(a_hi, b_hi) + _mm_f32(a_hi, b_lo) + _mm_f32(a_lo, b_hi)


@with_matmul_precision
def gemm(res, A, B, alpha: float = 1.0, beta: float = 0.0, C=None,
         trans_a: bool = False, trans_b: bool = False,
         compute_type=None, precision=None, guard_mode=None):
    """C = alpha·op(A)·op(B) + beta·C.

    ``compute_type``: None accumulates in f32 (f64 for f64 inputs).
    ``precision`` ('default' | 'high' | 'highest', or an alias) is the
    tier of this call; None follows the tier in effect
    (``util.precision.current_mode``)."""
    A = as_tensor(A, res)
    B = as_tensor(B, res)
    resolve_guard_mode(guard_mode)
    if compute_type is None:
        compute_type = (torch.float64 if A.dtype == torch.float64
                        else torch.float32)
    tier = resolve(precision) or current_mode()
    out = _product(A, B, trans_a, trans_b, compute_type, tier)
    out = (alpha * out).to(A.dtype) if alpha != 1.0 else out.to(A.dtype)
    if C is not None and beta != 0.0:
        out = out + beta * as_tensor(C, res)
    return out


@with_matmul_precision
def gemv(res, A, x, alpha: float = 1.0, beta: float = 0.0, y=None,
         trans: bool = False):
    """y = alpha·op(A)·x + beta·y, in f32 with TF32 off."""
    A = as_tensor(A, res)
    x = as_tensor(x, res)
    if trans:
        A = A.T
    out = alpha * (A @ x)
    if y is not None and beta != 0.0:
        out = out + beta * as_tensor(y, res)
    return out.to(A.dtype)


def axpy(res, alpha: float, x, y):
    """y = alpha·x + y."""
    return alpha * as_tensor(x, res) + as_tensor(y, res)


@with_matmul_precision
def dot(res, x, y):
    """Inner product, accumulated in f32 (f64 for f64 inputs)."""
    x = as_tensor(x, res)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    return torch.dot(x.ravel().to(acc),
                     as_tensor(y, res).ravel().to(acc)).to(x.dtype)


def transpose(res, A):
    """Out-of-place transpose."""
    A = as_tensor(A, res)
    return A.permute(*reversed(range(A.ndim))).contiguous()


def scal(res, alpha: float, x):
    return alpha * as_tensor(x, res)


def mean_squared_error(res, a, b, weight: float = 1.0):
    """weight · mean((a - b)^2)."""
    d = as_tensor(a, res) - as_tensor(b, res)
    return weight * torch.mean(d * d)
