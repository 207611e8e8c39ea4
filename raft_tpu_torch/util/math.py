"""Integer and layout math (counterpart of ``raft_tpu/util/math.py``)."""

from __future__ import annotations

import numpy as np


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up_to_multiple(x: int, m: int) -> int:
    return cdiv(x, m) * m


def round_down_to_multiple(x: int, m: int) -> int:
    return (x // m) * m


def is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def next_pow2(x: int) -> int:
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def prev_pow2(x: int) -> int:
    if x < 1:
        raise ValueError("prev_pow2 requires x >= 1")
    return 1 << (x.bit_length() - 1)


class Pow2:
    """Power-of-two layout math."""

    def __init__(self, value: int):
        if not is_pow2(value):
            raise ValueError(f"{value} is not a power of two")
        self.value = value
        self.mask = value - 1
        self.log2 = value.bit_length() - 1

    def round_down(self, x: int) -> int:
        return x & ~self.mask

    def round_up(self, x: int) -> int:
        return (x + self.mask) & ~self.mask

    def div(self, x: int) -> int:
        return x >> self.log2

    def mod(self, x: int) -> int:
        return x & self.mask

    def is_aligned(self, x: int) -> bool:
        return (x & self.mask) == 0


class FastIntDiv:
    """Division by a runtime constant, for host loops."""

    def __init__(self, divisor: int):
        if divisor <= 0:
            raise ValueError("divisor must be positive")
        self.divisor = divisor

    def div(self, x: int) -> int:
        return x // self.divisor

    def mod(self, x: int) -> int:
        return x % self.divisor

    def __call__(self, x: int) -> int:
        return self.div(x)


def bound_by_power_of_two_and_ratio(total: int, cap_pow2: int,
                                    ratio: int) -> int:
    """The largest power-of-two tile <= ``cap_pow2`` that splits
    ``total`` into at least ``ratio`` pieces."""
    tile = min(cap_pow2, next_pow2(max(1, total // ratio)))
    return max(1, prev_pow2(tile))


class Seive:
    """Prime sieve over [0, n] (the reference's name, spelling kept).

    >>> s = Seive(30)
    >>> s.is_prime(29), s.is_prime(28), s.get_num_primes()
    (True, False, 10)
    """

    def __init__(self, n: int):
        self._n = int(n)
        sieve = np.ones(max(self._n + 1, 2), dtype=bool)
        sieve[:2] = False
        for p in range(2, int(self._n ** 0.5) + 1):
            if sieve[p]:
                sieve[p * p::p] = False
        self._sieve = sieve
        self._primes = np.nonzero(sieve)[0]

    def is_prime(self, num: int) -> bool:
        if not 0 <= num <= self._n:
            raise ValueError(f"{num} outside sieve range [0, {self._n}]")
        return bool(self._sieve[num])

    def get_num_primes(self) -> int:
        return int(self._primes.shape[0])

    def get_primes(self):
        return self._primes.copy()
