"""Elementwise operations (counterpart of ``raft_tpu/linalg/eltwise.py``):
the reference's calling shapes and its scalar variants over torch ops."""

from __future__ import annotations

import math

import torch

from raft_tpu_torch.core.resources import as_tensor, default_resources


def add(res, a, b):
    return as_tensor(a, res) + as_tensor(b, res)


def add_scalar(res, a, scalar):
    return as_tensor(a, res) + scalar


def subtract(res, a, b):
    return as_tensor(a, res) - as_tensor(b, res)


def subtract_scalar(res, a, scalar):
    return as_tensor(a, res) - scalar


def multiply(res, a, b):
    return as_tensor(a, res) * as_tensor(b, res)


def multiply_scalar(res, a, scalar):
    return as_tensor(a, res) * scalar


def divide(res, a, b):
    return as_tensor(a, res) / as_tensor(b, res)


def divide_scalar(res, a, scalar):
    return as_tensor(a, res) / scalar


def power(res, a, b):
    return torch.pow(as_tensor(a, res), as_tensor(b, res))


def power_scalar(res, a, scalar):
    return torch.pow(as_tensor(a, res), scalar)


def sqrt(res, a):
    # NaN on negative input is the public elementwise op's contract
    return torch.sqrt(as_tensor(a, res))


def unary_op(res, a, op):
    """out[i] = op(a[i])."""
    return op(as_tensor(a, res))


def write_only_unary_op(res, shape, op, dtype=torch.float32):
    """out[i] = op(i) over a fresh tensor on the handle's device, in
    ``dtype`` (a torch dtype)."""
    shape = tuple(shape)
    idx = torch.arange(math.prod(shape),
                       device=default_resources(res).device).reshape(shape)
    return torch.as_tensor(op(idx)).to(dtype)


def binary_op(res, a, b, op):
    return op(as_tensor(a, res), as_tensor(b, res))


def ternary_op(res, a, b, c, op):
    return op(as_tensor(a, res), as_tensor(b, res), as_tensor(c, res))
