"""Typed numeric errors of the port (the taxonomy of
``raft_tpu/core/guards.py``, restricted to what this slice raises).

Every type is a ``RuntimeError``, so callers that catch ``RuntimeError``
keep working. Guard modes (``check``/``recover``) are not ported yet:
entry points take ``guard_mode=None`` or ``"off"`` only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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


def resolve_guard_mode(mode: Optional[str], op: str) -> str:
    """Only the ``off`` mode exists in the port so far: ``None`` and
    ``"off"`` resolve to it, anything else raises."""
    if mode is None or str(mode).lower() == "off":
        return "off"
    raise NotImplementedError(
        f"{op}: guard_mode={mode!r} is not ported yet (ROADMAP.md, queue "
        "A item 13: runtime + obs); use guard_mode=None or 'off'")
