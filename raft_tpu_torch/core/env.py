"""Registry of the ``RAFT_TPU_*`` environment knobs the port reads.

The same contract as ``raft_tpu/core/env.py``: every knob is declared
here with its parser and default and read through :func:`read`; library
code never reads ``os.environ`` for a ``RAFT_TPU_*`` key itself. A
malformed value raises ``ValueError`` naming the variable, at the read
site, so a typo never silently becomes a default. An empty string counts
as unset.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict

__all__ = ["EnvVar", "register", "read", "PRECISION_ALIASES"]

# Tier spellings accepted by RAFT_TPU_MATMUL_PRECISION and
# util.precision.set_matmul_precision (the reference package's aliases).
PRECISION_ALIASES = {
    "default": "default", "fastest": "default", "bfloat16": "default",
    "high": "high", "bfloat16_3x": "high", "tensorfloat32": "high",
    "highest": "highest", "float32": "highest", "f32": "highest",
}


@dataclass(frozen=True)
class EnvVar:
    name: str
    parse: Callable[[str], Any]
    default: Any
    help: str


_REGISTRY: Dict[str, EnvVar] = {}
_UNSET = object()


def register(name: str, parse: Callable[[str], Any], default: Any = None,
             help: str = "") -> EnvVar:
    spec = EnvVar(name, parse, default, help)
    _REGISTRY[name] = spec
    return spec


def read(name: str, default: Any = _UNSET) -> Any:
    """Read and parse one registered knob. Unset or empty returns the
    default; a malformed value raises ``ValueError`` naming the
    variable; an unregistered name raises ``KeyError``."""
    spec = _REGISTRY.get(name)
    if spec is None:
        raise KeyError(f"{name} is not a registered knob; declare it in "
                       f"raft_tpu_torch/core/env.py")
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return spec.default if default is _UNSET else default
    try:
        return spec.parse(raw)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None


def _parse_precision(raw: str) -> str:
    canon = PRECISION_ALIASES.get(raw.lower())
    if canon is None:
        raise ValueError(f"want one of {sorted(set(PRECISION_ALIASES))}, "
                         f"got {raw!r}")
    return canon


def _parse_flag(raw: str) -> bool:
    """Loose boolean, as the reference package reads it: anything but
    0/false is on."""
    return raw.lower() not in ("0", "false")


register("RAFT_TPU_MATMUL_PRECISION", _parse_precision, "high",
         help="matmul precision tier; see util/precision.py")
register("RAFT_TPU_SPARSE_PAD", _parse_flag, True,
         help="pad CSR indices/data to an nnz size class in from_scipy "
              "(core/sparse_types.py); changes the physical nnz")
