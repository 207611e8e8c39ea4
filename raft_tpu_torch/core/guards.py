"""Typed numeric errors of the port (the taxonomy of
``raft_tpu/core/guards.py``, restricted to what this slice raises).

Every type is a ``RuntimeError``, so callers that catch ``RuntimeError``
keep working. Guard modes (``check``/``recover``) are not ported yet:
:func:`resolve_guard_mode` resolves ``guard_mode=`` as the reference
package does and raises ``NotImplementedError`` for either.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from raft_tpu_torch.core import env as _env_mod

__all__ = ["NumericalError", "NonFiniteError", "IllConditionedError",
           "ConvergenceError", "ConvergenceReport", "resolve_guard_mode"]


class NumericalError(RuntimeError):
    """Base numeric failure; ``op`` names the operation that saw it."""

    def __init__(self, message: str, *, op: Optional[str] = None):
        super().__init__(message)
        self.op = op


class NonFiniteError(NumericalError):
    """NaN or Inf crossed a checked boundary. ``stage`` is ``"input"``
    when the caller handed in poisoned data, ``"output"`` when the op
    produced it from finite inputs."""

    def __init__(self, message: str, *, op: Optional[str] = None,
                 stage: str = "output"):
        super().__init__(message, op=op)
        self.stage = stage


class IllConditionedError(NumericalError):
    """The input's conditioning makes the operation undefined, such as a
    zero or non-finite starting vector for Lanczos."""


@dataclasses.dataclass
class ConvergenceReport:
    """Outcome of an iterative solver. For k-means ``residual`` is the
    relative inertia change at the last poll."""

    converged: bool
    n_iter: int
    residual: float
    tol: float
    escalated: bool = False
    breakdowns: int = 0
    detail: str = ""


class ConvergenceError(NumericalError):
    """An iterative solver ran out of iterations under ``strict=True``;
    ``.report`` carries the :class:`ConvergenceReport`."""

    def __init__(self, message: str, *,
                 report: Optional[ConvergenceReport] = None,
                 op: Optional[str] = None):
        super().__init__(message, op=op)
        self.report = report


GUARD_MODES = ("off", "check", "recover")

_mode = _env_mod.read("RAFT_TPU_GUARD_MODE")


def resolve_guard_mode(override: Optional[str] = None) -> str:
    """Per-call override resolution, as the reference package's: an
    explicit ``guard_mode=`` argument wins, None gives the global mode
    (``RAFT_TPU_GUARD_MODE``), an unknown mode raises ``ValueError``.
    Only ``off`` is ported: ``check`` and ``recover`` raise
    ``NotImplementedError``."""
    mode = _mode if override is None else str(override).lower()
    if mode not in GUARD_MODES:
        raise ValueError(
            f"unknown guard mode {override!r}; want one of {GUARD_MODES}")
    if mode != "off":
        raise NotImplementedError(
            f"guard_mode={mode!r} is not ported yet (ROADMAP.md, queue A "
            "item 13b: guard modes); use guard_mode=None or 'off'")
    return mode
