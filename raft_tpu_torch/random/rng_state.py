"""PRNG state over ``torch.Generator`` (counterpart of
``raft_tpu/random/rng_state.py``).

The same shape as the reference package's state: a seed plus an
advancing subsequence counter. Each call takes a fresh generator seeded
from ``(seed, subsequence)``, so results depend on the call order and
never on PyTorch's global RNG. The streams are not JAX's threefry
streams: tests that compare the two packages feed both the same numpy
inputs.

The reference's key API carries over with a generator for a key:
:meth:`RngState.key` is the current subsequence's generator,
:meth:`RngState.next_key` that generator with the state advanced (one a
call, as every generator of :mod:`raft_tpu_torch.random.rng` takes), and
:meth:`RngState.split` gives ``n`` child states, also advancing once, so
``base_subsequence`` follows the reference's after the same calls. A
child's seed is a hash of its parent's seed, subsequence and index, so
children of children never meet a stream of their ancestors. Keys land
on the process-wide handle's device (``cuda:0``) unless the caller names
one.

``type`` names the reference's generator (threefry or rbg). It travels
with the state, through checkpoints too, but draws nothing here: every
stream of the port is torch's Philox.
"""

from __future__ import annotations

import enum
import hashlib

import torch

_MIX = 0x9E3779B97F4A7C15          # 64-bit golden-ratio constant
_MASK63 = (1 << 63) - 1


class GeneratorType(enum.Enum):
    """The reference's generator kinds, with its values."""

    THREEFRY = "threefry"
    RBG = "rbg"


class RngState:
    def __init__(self, seed: int = 0, base_subsequence: int = 0,
                 type: GeneratorType = GeneratorType.THREEFRY):
        self.seed = int(seed)
        self.base_subsequence = int(base_subsequence)
        self.type = type

    def advance(self, max_streams_used: int = 1,
                max_calls_per_subsequence: int = 1) -> None:
        """Move to a fresh subsequence for the next call."""
        self.base_subsequence += int(max_streams_used) * int(
            max_calls_per_subsequence)

    def key(self, device=None) -> torch.Generator:
        """The generator of the current subsequence (the reference's key;
        the state does not move), on ``device``: ``None`` is the
        process-wide handle's device."""
        if device is None:
            from raft_tpu_torch.core import resources
            device = resources.default_resources(None).device
        g = torch.Generator(device=device)
        g.manual_seed((self.seed * _MIX + self.base_subsequence) & _MASK63)
        return g

    def next_key(self, device=None) -> torch.Generator:
        """The key for this call, then advance: one a generator call."""
        g = self.key(device)
        self.advance()
        return g

    def split(self, n: int):
        """``n`` independent states for parallel streams; the state
        advances once. Child ``i`` starts at subsequence 0 of a seed
        hashed from ``(seed, base_subsequence, i)``, so siblings, the
        parent's later calls and nested splits draw distinct streams."""
        n = int(n)
        if n < 0:
            raise ValueError(f"split: n must be >= 0, got {n}")
        parent = f"{self.seed}:{self.base_subsequence}"
        self.advance()
        return [RngState(_child_seed(parent, i), 0, self.type)
                for i in range(n)]

    def __repr__(self):
        return (f"RngState(seed={self.seed}, "
                f"base_subsequence={self.base_subsequence}, "
                f"type={self.type.value})")


def _child_seed(parent: str, i: int) -> int:
    """A 63-bit seed from the parent's ``seed:subsequence`` and the
    child's index (BLAKE2b)."""
    digest = hashlib.blake2b(f"{parent}:{i}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little") & _MASK63
