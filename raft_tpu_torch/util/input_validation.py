"""Entry-point argument checks (counterpart of
``raft_tpu/util/input_validation.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.guards import NonFiniteError


def expect_2d(arr, name: str = "array") -> None:
    if arr.ndim != 2:
        raise ValueError(f"{name}: expected 2-D array, got ndim={arr.ndim}")


def expect_positive(value, name: str = "value",
                    strict: bool = True) -> None:
    """A host scalar (or 0-d tensor) that must be > 0 (>= 0 when
    ``strict=False``) and finite."""
    import math

    v = float(value)
    ok = v > 0.0 if strict else v >= 0.0
    if not (math.isfinite(v) and ok):
        bound = ">" if strict else ">="
        raise ValueError(f"{name}: expected a finite value {bound} 0, "
                         f"got {v!r}")


def expect_finite(arr: torch.Tensor, name: str = "array",
                  guard_mode: Optional[str] = None) -> None:
    """All-finite check, gated on the guard mode as in the reference
    package: ``None``/``"off"`` (the default there) checks nothing;
    ``"check"``/``"recover"`` raise :class:`NonFiniteError` naming the
    argument."""
    mode = "off" if guard_mode is None else str(guard_mode).lower()
    if mode == "off":
        return
    if mode not in ("check", "recover"):
        raise ValueError(f"unknown guard mode {guard_mode!r}")
    if arr.is_floating_point() and not bool(torch.isfinite(arr).all()):
        raise NonFiniteError(
            f"{name}: non-finite values detected at the input boundary "
            f"(guard_mode={mode!r})", op=name, stage="input")


def expect_one_sync(sync_every: Optional[int], op: str) -> None:
    """``sync_every`` validated; above 1 (steps chunked into one device
    program, the reference's compiled driver) raises
    ``NotImplementedError``: it becomes a CUDA-graph capture with the
    runtime port (ROADMAP.md, queue A item 13)."""
    if resolve_sync_every(sync_every) > 1:
        raise NotImplementedError(
            f"{op}: sync_every > 1 (steps chunked into one device program) "
            "is not ported yet; it becomes a CUDA-graph capture with the "
            "runtime port (ROADMAP.md, queue A item 13). sync_every=1 is "
            "the same algorithm.")


def resolve_sync_every(sync_every: Optional[int]) -> int:
    """``sync_every`` validated as in the reference package's
    ``runtime.compiled_driver.resolve_sync_every``; ``None`` is 1 (the
    reference's cost model has no counterpart yet)."""
    if sync_every is None:
        return 1
    n = int(sync_every)
    if n < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    return n
