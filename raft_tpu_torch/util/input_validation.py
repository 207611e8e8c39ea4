"""Entry-point argument checks (counterpart of
``raft_tpu/util/input_validation.py``): the same error types and
messages, on tensors and torch dtypes.

Shape and dtype checks read metadata only and are always on.
``expect_finite`` scans values, so it is gated on the guard mode.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.guards import NonFiniteError


def expect(cond: bool, msg: str) -> None:
    """Raise ``ValueError(msg)`` unless ``cond``."""
    if not cond:
        raise ValueError(msg)


def expect_shape(arr, shape, name: str = "array") -> None:
    """``arr``'s shape is ``shape`` (a ``None`` entry matches any
    extent)."""
    actual = tuple(arr.shape)
    expected = tuple(shape)
    if len(actual) != len(expected) or any(
            e is not None and a != e for a, e in zip(actual, expected)):
        raise ValueError(f"{name}: expected shape {expected}, got {actual}")


def expect_2d(arr, name: str = "array") -> None:
    if arr.ndim != 2:
        raise ValueError(f"{name}: expected 2-D array, got ndim={arr.ndim}")


def expect_same_shape(a, b, names=("a", "b")) -> None:
    if tuple(a.shape) != tuple(b.shape):
        raise ValueError(
            f"{names[0]} shape {tuple(a.shape)} != {names[1]} shape "
            f"{tuple(b.shape)}")


def expect_square(arr, name: str = "array") -> None:
    """A 2-D array with equal dims."""
    shape = tuple(arr.shape)
    if len(shape) != 2 or shape[0] != shape[1]:
        raise ValueError(f"{name}: expected a square matrix, got shape "
                         f"{shape}")


def expect_dtype(arr, dtypes, name: str = "array") -> None:
    """Dtype membership check, raising ``TypeError``. ``dtypes`` is one
    dtype-like (torch, numpy or a name) or a sequence of them; the
    message names numpy's spellings, as the reference's does."""
    from raft_tpu_torch.core.mdarray import torch_dtype

    if not isinstance(dtypes, (tuple, list, set)):
        dtypes = (dtypes,)
    want = {torch_dtype(d) for d in dtypes}
    got = torch_dtype(arr.dtype)
    if got not in want:
        raise TypeError(
            f"{name}: dtype {_dtype_name(got)} not in "
            f"{sorted(_dtype_name(d) for d in want)}")


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``float32``, ``bool``,
    ``bfloat16``)."""
    return str(dtype).replace("torch.", "")


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
    """``sync_every`` validated for the solvers not yet chunked
    (``kmeans_fit_mnmg``, Lanczos, ``pca_partial_fit``): ``None`` is 1
    (their host-driven path on the card too, where
    :func:`resolve_sync_every`'s default is 16), and an explicit value
    above 1 raises ``NotImplementedError``: their chunks on the compiled
    driver are ROADMAP.md queue A item 13b."""
    if sync_every is None:
        return
    if resolve_sync_every(sync_every) > 1:
        raise NotImplementedError(
            f"{op}: sync_every > 1 (steps chunked into one CUDA graph) is "
            "not ported yet for this solver (ROADMAP.md, queue A item "
            "13b). sync_every=1 is the same algorithm.")


def resolve_sync_every(sync_every: Optional[int], *, device=None) -> int:
    """``sync_every`` validated, with ``None`` resolved by
    :func:`raft_tpu_torch.runtime.compiled_driver.resolve_sync_every`'s
    cost model (1 on the CPU, 16 on a CUDA card)."""
    from raft_tpu_torch.runtime import compiled_driver

    return compiled_driver.resolve_sync_every(sync_every, device=device)
