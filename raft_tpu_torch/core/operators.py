"""Composable operator vocabulary of the map and reduce primitives
(counterpart of ``raft_tpu/core/operators.py``, on torch ops).

The reference package's functors as plain callables over tensors, with
the same composition helpers (``compose_op``, ``plug_const_op``,
``map_args_op``). ``linalg.reduce`` picks its reduction by the identity
of these objects (``reduce_op is add_op``), so callers pass the port's
own operators, not the reference's.
"""

from __future__ import annotations

import torch


# -- unary ------------------------------------------------------------------

def identity_op(x, *_):
    return x


def void_op(*_):
    return None


def abs_op(x, *_):
    return torch.abs(x)


def sq_op(x, *_):
    return x * x


def sqrt_op(x, *_):
    return torch.sqrt(x)


def nz_op(x, *_):
    return torch.where(x != 0, torch.ones_like(x), torch.zeros_like(x))


def key_op(kvp, *_):
    return kvp[0]


def value_op(kvp, *_):
    return kvp[1]


# -- binary -----------------------------------------------------------------

def add_op(a, b):
    return a + b


def sub_op(a, b):
    return a - b


def mul_op(a, b):
    return a * b


def div_op(a, b):
    return a / b


def div_checkzero_op(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    zero = torch.zeros_like(a * b)
    return torch.where(b == 0, zero, a / torch.where(b == 0,
                                                     torch.ones_like(b), b))


def pow_op(a, b):
    return torch.pow(a, b)


def mod_op(a, b):
    """The floored modulo of ``jnp.mod`` (the sign of ``b``)."""
    return torch.remainder(a, b)


def min_op(a, b):
    return torch.minimum(a, b)


def max_op(a, b):
    return torch.maximum(a, b)


def argmin_op(kvp_a, kvp_b):
    """KeyValuePair argmin reduction: the smaller value, the lower key on
    equal values."""
    ka, va = kvp_a
    kb, vb = kvp_b
    take_b = (vb < va) | ((vb == va) & (kb < ka))
    return (torch.where(take_b, kb, ka), torch.where(take_b, vb, va))


def argmax_op(kvp_a, kvp_b):
    ka, va = kvp_a
    kb, vb = kvp_b
    take_b = (vb > va) | ((vb == va) & (kb < ka))
    return (torch.where(take_b, kb, ka), torch.where(take_b, vb, va))


def sqdiff_op(a, b):
    d = a - b
    return d * d


def absdiff_op(a, b):
    return torch.abs(a - b)


# -- combinators -------------------------------------------------------------

def compose_op(*fns):
    """compose_op(f, g, h)(x) == f(g(h(x)))."""

    def composed(*args):
        out = fns[-1](*args)
        for fn in reversed(fns[:-1]):
            out = fn(out)
        return out

    return composed


def const_op(value):
    def op(*_):
        return value

    return op


def plug_const_op(fn, const, side="right"):
    """Bind a constant to one side of a binary op."""
    if side == "right":
        return lambda x, *_: fn(x, const)
    return lambda x, *_: fn(const, x)


def add_const_op(c):
    return plug_const_op(add_op, c)


def sub_const_op(c):
    return plug_const_op(sub_op, c)


def mul_const_op(c):
    return plug_const_op(mul_op, c)


def div_const_op(c):
    return plug_const_op(div_op, c)


def pow_const_op(c):
    return plug_const_op(pow_op, c)


def map_args_op(fn, *maps):
    """map_args_op(f, g1, g2)(x1, x2) == f(g1(x1), g2(x2))."""

    def op(*args):
        return fn(*(g(a) for g, a in zip(maps, args)))

    return op
