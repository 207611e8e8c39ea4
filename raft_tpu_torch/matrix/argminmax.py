"""Per-row argmin/argmax under the reference's older module name
(counterpart of ``raft_tpu/matrix/argminmax.py``, a shim): the same
callables as :mod:`raft_tpu_torch.matrix.epilogue`."""

from __future__ import annotations

from raft_tpu_torch.matrix.epilogue import argmax, argmin  # noqa: F401

__all__ = ["argmin", "argmax"]
