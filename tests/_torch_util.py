"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
numpy references for the precision tiers and the near-tie rule for
comparing labels between the two packages."""

from __future__ import annotations

import contextlib

import jax
import numpy as np
import torch

from raft_tpu_torch.util import precision as tprec

TIERS = ("default", "high", "highest")


@contextlib.contextmanager
def both_tiers(tier: str):
    """Run a region at ``tier`` in both packages."""
    with jax.default_matmul_precision(tier), tprec.scope(tier):
        yield


def bf16_round(a: np.ndarray) -> np.ndarray:
    """f32 -> nearest bf16 value (half to even), as f32 (finite input)."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def one_pass_cross(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """x·yᵀ of one bf16 pass: operands rounded to bf16, products and sums
    in f64 (the products are exact in f32, so only the order differs)."""
    return bf16_round(x).astype(np.float64) @ bf16_round(y).astype(
        np.float64).T


def sq_norms(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float64)
    return (a * a).sum(1)


def exact_l2(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    return ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)


def assert_labels_agree(got, want, d, scale, rel: float = 1e-5,
                        max_frac: float = 0.01):
    """Labels must be equal except at near-ties: rows where the two
    chosen columns' distances in ``d`` (an accurate distance matrix)
    differ by at most ``rel * scale`` for that row. At most ``max_frac``
    of the rows may differ at all."""
    got = np.asarray(got)
    want = np.asarray(want)
    bad = np.nonzero(got != want)[0]
    assert bad.size <= max(1, int(max_frac * got.size)), \
        f"{bad.size} of {got.size} labels differ"
    for i in bad:
        gap = abs(d[i, got[i]] - d[i, want[i]])
        assert gap <= rel * scale[i], \
            f"row {i}: labels {got[i]} vs {want[i]} differ by {gap} > tie " \
            f"band {rel * scale[i]}"


def t(a) -> torch.Tensor:
    """numpy -> CPU tensor (the port's plain versions)."""
    return torch.from_numpy(np.ascontiguousarray(a))


def n(a) -> np.ndarray:
    """tensor or JAX array -> numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
