"""Integer layout math (counterpart of ``raft_tpu/util/math.py``)."""

from __future__ import annotations


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up_to_multiple(x: int, m: int) -> int:
    return cdiv(x, m) * m
