"""PRNG state over ``torch.Generator`` (counterpart of
``raft_tpu/random/rng_state.py``).

The same shape as the reference package's state: a seed plus an
advancing subsequence counter. Each call takes a fresh generator seeded
from ``(seed, subsequence)``, so results depend on the call order and
never on PyTorch's global RNG. The streams are not JAX's threefry
streams: tests that compare the two packages feed both the same numpy
inputs.
"""

from __future__ import annotations

import torch

_MIX = 0x9E3779B97F4A7C15          # 64-bit golden-ratio constant
_MASK63 = (1 << 63) - 1


class RngState:
    def __init__(self, seed: int = 0, base_subsequence: int = 0):
        self.seed = int(seed)
        self.base_subsequence = int(base_subsequence)

    def advance(self, max_streams_used: int = 1,
                max_calls_per_subsequence: int = 1) -> None:
        """Move to a fresh subsequence for the next call."""
        self.base_subsequence += int(max_streams_used) * int(
            max_calls_per_subsequence)

    def generator(self, device="cpu") -> torch.Generator:
        """A generator on ``device`` for the current subsequence."""
        g = torch.Generator(device=device)
        g.manual_seed((self.seed * _MIX + self.base_subsequence) & _MASK63)
        return g

    def next_generator(self, device="cpu") -> torch.Generator:
        """Generator for this call, then advance."""
        g = self.generator(device)
        self.advance()
        return g

    def __repr__(self):
        return (f"RngState(seed={self.seed}, "
                f"base_subsequence={self.base_subsequence})")
