"""Owning n-d arrays tagged with a memory type and a layout (counterpart
of ``raft_tpu/core/mdarray.py``).

An :class:`MdArray` pairs a tensor with its
:class:`~raft_tpu_torch.core.memory_type.MemoryType`: a device tensor on
the handle's device for ``DEVICE`` and ``MANAGED``, a CPU tensor for
``HOST``, and a page-locked CPU tensor for ``PINNED`` wherever the
process has CUDA (plain host memory where it has none). Its view is the
tensor itself, which every entry point of the port takes.

Layouts: tensors are row-major. A ``COL_MAJOR`` buffer holds Aᵀ
contiguously, reshaped to A's shape, as the reference's does.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.memory_type import MemoryType
from raft_tpu_torch.core.resources import (Resources, default_resources,
                                           get_device)

ROW_MAJOR = "row_major"
COL_MAJOR = "col_major"


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype-like or a name
    (``"bfloat16"`` included)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(getattr(dtype, "name", dtype)) == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def pinned(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into page-locked host memory where the process has
    CUDA, else into plain host memory."""
    out = torch.empty(t.shape, dtype=t.dtype,
                      pin_memory=torch.cuda.is_available())
    out.copy_(t)
    return out


class MdArray:
    """Owning n-d tensor tagged with memory type and layout. ``data`` may
    be replaced, which stands in for the reference's mutable buffers."""

    def __init__(self, data: Any, memory_type: MemoryType,
                 layout: str = ROW_MAJOR):
        self.data = data
        self.memory_type = memory_type
        self.layout = layout

    def view(self):
        """The non-owning view: the tensor itself."""
        return self.data

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def size(self) -> int:
        return int(np.prod(self.data.shape)) if self.data.shape else 1

    def extent(self, axis: int) -> int:
        return int(self.data.shape[axis])

    def __array__(self, dtype=None, copy=None):
        arr = self.data.detach().cpu().numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __repr__(self):
        return (f"MdArray(shape={self.shape}, dtype={self.dtype}, "
                f"memory_type={self.memory_type.value}, layout={self.layout})")


def _place(res: Optional[Resources], t: torch.Tensor,
           memory_type: MemoryType) -> torch.Tensor:
    """``t`` in ``memory_type``'s space: the handle's device (``cuda:0``
    by default) for device-accessible types, page-locked host memory for
    ``PINNED``, the host for ``HOST``."""
    if memory_type.is_device_accessible:
        return t.to(get_device(default_resources(res)))
    if memory_type is MemoryType.PINNED:
        return t if t.is_pinned() else pinned(t.cpu())
    return t.cpu()


def _zeros(res: Optional[Resources], shape, dtype, memory_type: MemoryType,
           layout: str) -> MdArray:
    dtype = torch_dtype(dtype)
    if memory_type.is_device_accessible:
        data = torch.zeros(shape, dtype=dtype,
                           device=get_device(default_resources(res)))
    else:
        data = torch.zeros(shape, dtype=dtype,
                           pin_memory=(memory_type is MemoryType.PINNED
                                       and torch.cuda.is_available()))
    return MdArray(data, memory_type, layout)


def make_device_matrix(res, n_rows: int, n_cols: int, dtype=torch.float32,
                       layout: str = ROW_MAJOR) -> MdArray:
    return _zeros(res, (n_rows, n_cols), dtype, MemoryType.DEVICE, layout)


def make_device_vector(res, n: int, dtype=torch.float32) -> MdArray:
    return _zeros(res, (n,), dtype, MemoryType.DEVICE, ROW_MAJOR)


def make_device_scalar(res, value=0, dtype=torch.float32) -> MdArray:
    out = _zeros(res, (), dtype, MemoryType.DEVICE, ROW_MAJOR)
    out.data.fill_(value)
    return out


def make_device_mdarray(res, shape, dtype=torch.float32,
                        layout: str = ROW_MAJOR) -> MdArray:
    return _zeros(res, tuple(shape), dtype, MemoryType.DEVICE, layout)


def make_host_matrix(n_rows: int, n_cols: int, dtype=torch.float32,
                     layout: str = ROW_MAJOR) -> MdArray:
    return _zeros(None, (n_rows, n_cols), dtype, MemoryType.HOST, layout)


def make_host_vector(n: int, dtype=torch.float32) -> MdArray:
    return _zeros(None, (n,), dtype, MemoryType.HOST, ROW_MAJOR)


def make_host_scalar(value=0, dtype=torch.float32) -> MdArray:
    out = _zeros(None, (), dtype, MemoryType.HOST, ROW_MAJOR)
    out.data.fill_(value)
    return out


def make_pinned_matrix(n_rows: int, n_cols: int,
                       dtype=torch.float32) -> MdArray:
    return _zeros(None, (n_rows, n_cols), dtype, MemoryType.PINNED,
                  ROW_MAJOR)


def make_managed_matrix(res, n_rows: int, n_cols: int,
                        dtype=torch.float32) -> MdArray:
    return _zeros(res, (n_rows, n_cols), dtype, MemoryType.MANAGED,
                  ROW_MAJOR)


def copy(res: Optional[Resources], dst: MdArray, src: MdArray) -> None:
    """Copy ``src`` into ``dst``, converting memory type, dtype and
    layout: re-lay the buffer where the layouts differ, cast where the
    dtypes differ, and write into ``dst``'s own buffer where it already
    has the shape and dtype in its memory space (else replace it)."""
    if dst.shape != src.shape:
        raise ValueError(f"shape mismatch: dst {dst.shape} vs src {src.shape}")
    data = torch.as_tensor(src.data)
    if src.layout != dst.layout and len(src.shape) == 2:
        # a COL_MAJOR buffer stores A^T contiguously under A's shape;
        # flipping layout re-materializes the buffer in the other order
        if dst.layout == COL_MAJOR:
            data = data.t().reshape(src.shape)
        else:
            rows, cols = src.shape
            data = data.reshape(cols, rows).t().reshape(src.shape)
    data = data.to(torch_dtype(dst.dtype))
    if _holds(res, dst, data):
        # one transfer into dst's own buffer (page-locked for PINNED)
        dst.data.copy_(data)
    else:
        dst.data = _place(res, data.contiguous(), dst.memory_type)


def _holds(res, dst: MdArray, data: torch.Tensor) -> bool:
    """Whether ``dst``'s tensor can take ``data`` in place: same shape
    and dtype, contiguous, in ``dst``'s memory space."""
    t = dst.data
    if not (isinstance(t, torch.Tensor) and t.shape == data.shape
            and t.dtype == data.dtype and t.is_contiguous()):
        return False
    if dst.memory_type.is_device_accessible:
        return t.device == get_device(default_resources(res))
    if t.device.type != "cpu":
        return False
    return dst.memory_type is not MemoryType.PINNED or t.is_pinned() \
        or not torch.cuda.is_available()


class MdBuffer:
    """Buffer that materializes views in other memory types and dtypes on
    demand, copying only when needed and caching each view. Device views
    land on the handle's device (``res``, ``cuda:0`` by default)."""

    def __init__(self, source: Any, memory_type: Optional[MemoryType] = None,
                 res: Optional[Resources] = None):
        if isinstance(source, MdArray):
            self._mt = source.memory_type
            self._data = source.data
        else:
            data = (source if isinstance(source, torch.Tensor)
                    else torch.as_tensor(np.asarray(source)))
            self._mt = memory_type or (
                MemoryType.DEVICE if data.device.type == "cuda"
                else MemoryType.HOST)
            self._data = data
        self._res = res
        self._cache = {(self._mt, self._data.dtype): self._data}

    @property
    def memory_type(self) -> MemoryType:
        return self._mt

    def view(self, memory_type: Optional[MemoryType] = None, dtype=None):
        memory_type = memory_type or self._mt
        dtype = self._data.dtype if dtype is None else torch_dtype(dtype)
        key = (memory_type, dtype)
        if key not in self._cache:
            data = self._data
            if memory_type.is_device_accessible != self._mt.is_device_accessible \
                    or memory_type is MemoryType.PINNED:
                data = _place(self._res, data, memory_type)
            self._cache[key] = data.to(dtype)
        return self._cache[key]

    def is_copy_required(self, memory_type: MemoryType) -> bool:
        return memory_type.is_device_accessible != self._mt.is_device_accessible


def temporary_device_buffer(res, array) -> Any:
    """A device-accessible view of possibly-host data: a CUDA tensor as
    it is, anything else copied to the handle's device."""
    if isinstance(array, torch.Tensor) and array.device.type == "cuda":
        return array
    t = array if isinstance(array, torch.Tensor) else torch.as_tensor(
        np.asarray(array))
    return _place(res, t, MemoryType.DEVICE)
