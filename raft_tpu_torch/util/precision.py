"""Matmul precision tiers (counterpart of ``raft_tpu/util/precision.py``).

The three tiers keep the reference package's meanings:

- ``'default'``: one bf16 pass. Both operands are rounded to bf16
  (round half to even) and the products accumulate in f32.
- ``'high'`` (the default): bf16x3. Each f32 operand is split into bf16
  halves ``hi + lo`` and the product is ``hi·hi + hi·lo + lo·hi``
  (about 2^-17 relative; the dropped ``lo·lo`` term is below that).
- ``'highest'``: full f32.

PyTorch's own ``"high"`` float32 matmul precision means TF32, which is
none of these tiers. So :func:`scope` pins
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to ``False`` for its duration and
restores them after.

``RAFT_TPU_MATMUL_PRECISION`` sets the initial tier; a malformed value
raises at import (``core/env.py``).
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional

import torch

from raft_tpu_torch.core import env

__all__ = ["TIERS", "set_matmul_precision", "get_matmul_precision",
           "current_mode", "scope", "with_matmul_precision", "canonical"]

TIERS = ("default", "high", "highest")

_policy = env.read("RAFT_TPU_MATMUL_PRECISION")
_tls = threading.local()


def canonical(name: str) -> str:
    """Canonical tier of a spelling, or ``ValueError``."""
    canon = env.PRECISION_ALIASES.get(str(name).lower())
    if canon is None:
        raise ValueError(f"unknown precision {name!r}; want one of "
                         f"{list(TIERS)} (or an alias)")
    return canon


def set_matmul_precision(name: str) -> None:
    """Set the process-wide tier."""
    global _policy
    _policy = canonical(name)


def get_matmul_precision() -> str:
    return _policy


def _stack():
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def current_mode() -> str:
    """The tier in effect: the innermost :func:`scope` that named one,
    else the process-wide tier."""
    st = _stack()
    return st[-1] if st else _policy


@contextlib.contextmanager
def scope(name: Optional[str] = None):
    """Run a region at tier ``name`` (``None`` keeps the tier in effect),
    with TF32 off for cuBLAS and cuDNN."""
    tier = current_mode() if name is None else canonical(name)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _stack().append(tier)
    try:
        yield tier
    finally:
        _stack().pop()
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def with_matmul_precision(fn):
    """Decorator: run ``fn`` under :func:`scope` (TF32 pinned off)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with scope():
            return fn(*args, **kwargs)

    return wrapper
