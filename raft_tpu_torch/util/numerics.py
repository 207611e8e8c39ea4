"""Precision-escalation ladder and host-f64 helpers (counterpart of
``raft_tpu/util/numerics.py``).

The ladder extends ``util/precision.py``'s matmul tiers with a host
float64 rung:

    ``default`` (one bf16 pass) → ``high`` (bf16x3) → ``highest``
    (full f32, TF32 off) → ``f64`` (float64 on the host)

A matmul-shaped op retries under the next tier; a factorization whose
breakdown is limited by its dtype rather than its matmul tier jumps to
the ``f64`` rung and recomputes the failing step in float64 on the host.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.util import precision

__all__ = ["LADDER", "next_tier", "tier_scope", "matmul_escalation",
           "f64_host"]

#: lowest to highest
LADDER = ("default", "high", "highest", "f64")


def next_tier(tier: Optional[str] = None) -> Optional[str]:
    """The rung above ``tier`` (default: the matmul tier in effect), or
    None at the top of the ladder; an unknown spelling counts as
    already-maximal matmul accuracy."""
    if tier is None:
        tier = precision.current_mode()
    try:
        i = LADDER.index(str(tier).lower())
    except ValueError:
        return "f64"
    return LADDER[i + 1] if i + 1 < len(LADDER) else None


@contextlib.contextmanager
def tier_scope(tier: str):
    """Run a region at one rung: a matmul rung is
    :func:`raft_tpu_torch.util.precision.scope` (TF32 pinned off); the
    ``f64`` rung changes nothing, since f64 escalation is per-op host
    arithmetic (:func:`f64_host`)."""
    tier = str(tier).lower()
    if tier == "f64":
        yield
    elif tier in ("default", "high", "highest"):
        with precision.scope(tier):
            yield
    else:
        raise ValueError(f"unknown ladder tier {tier!r}; want one of "
                         f"{LADDER}")


def matmul_escalation(compute, op: str = ""):
    """A rerun of ``compute`` (a nullary closure over the original
    operands) one matmul rung up, or None where matmul accuracy is
    already maximal ('highest')."""
    nt = next_tier()
    if nt is None or nt == "f64":
        return None

    def rerun():
        with tier_scope(nt):
            return compute()

    return rerun


def f64_host(*arrays):
    """Operands as float64 numpy arrays on the host, the top rung."""
    out = tuple(np.asarray(a.detach().cpu().double() if isinstance(
        a, torch.Tensor) else a, np.float64) for a in arrays)
    return out[0] if len(out) == 1 else out
