"""n-ary elementwise maps (counterpart of ``raft_tpu/linalg/map.py``):
RAFT's calling shapes (the op first-class, n-ary inputs, offset
variants) over torch ops."""

from __future__ import annotations

import math

import torch

from raft_tpu_torch.core.resources import as_tensor, default_resources
from raft_tpu_torch.linalg.reduce import _fold


def _ins(res, ins):
    return [as_tensor(x, res) for x in ins]


def map(res, op, *ins):
    """out[i] = op(ins0[i], ins1[i], ...)."""
    return op(*_ins(res, ins))


def map_offset(res, op, shape_or_ref, *ins):
    """out[i] = op(i, ins0[i], ...). ``shape_or_ref`` gives the output
    shape (an int, a tuple, or an array whose shape is used); the flat
    offset is the op's first argument, on the device of the reference
    tensor, else of the first input, else the handle's."""
    tensors = _ins(res, ins)
    if isinstance(shape_or_ref, int):
        shape, device = (shape_or_ref,), None
    elif isinstance(shape_or_ref, tuple):
        shape, device = shape_or_ref, None
    else:
        shape = tuple(shape_or_ref.shape)
        device = getattr(shape_or_ref, "device", None)
    if device is None:
        device = (tensors[0].device if tensors
                  else default_resources(res).device)
    idx = torch.arange(math.prod(shape), device=device).reshape(shape)
    return op(idx, *tensors)


def map_reduce(res, op, reduce_op, init, *ins):
    """reduce(op(ins...)) to a scalar, from ``init``: a sum for
    ``torch.add`` or ``None``, else a pairwise fold of ``reduce_op``."""
    flat = op(*_ins(res, ins)).ravel()
    if reduce_op in (torch.add, None):
        return torch.sum(flat) + init
    init_val = torch.as_tensor(init, dtype=flat.dtype, device=flat.device)
    if flat.numel() == 0:
        return init_val
    return reduce_op(init_val, _fold(flat, reduce_op, 0))


def map_then_reduce(res, op, *ins):
    """Sum of a mapped expression, the minor axis first, as the
    reference stages it."""
    mapped = op(*_ins(res, ins))
    if mapped.ndim <= 1:
        return torch.sum(mapped)
    return torch.sum(torch.sum(mapped, dim=-1))
