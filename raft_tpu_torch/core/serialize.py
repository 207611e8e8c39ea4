"""Array ⇄ NumPy ``.npy`` stream serialization (counterpart of
``raft_tpu/core/serialize.py``).

Host and device tensors are written to and read from the NumPy binary
format, byte for byte the reference package's, so each package reads the
other's streams. NumPy has no bf16: a bf16 array travels as the
reference's one-field structured dtype ``[("bfloat16", "<u2")]`` (the
same bytes, self-describing), and such a stream reads back as a
``torch.bfloat16`` tensor. This module is the port's one copy of that
wire code (``core/checkpoint`` writes its entries through it).
"""

from __future__ import annotations

import io
from typing import Any, BinaryIO, Optional, Union

import numpy as np
import torch

from raft_tpu_torch.core.mdarray import MdArray
from raft_tpu_torch.core.resources import (Resources, default_resources,
                                           get_device)

_BF16_WIRE = np.dtype([("bfloat16", np.uint16)])


def host_array(array: Any) -> np.ndarray:
    """The host array ``.npy`` holds: a tensor's values (bf16 as its wire
    dtype), a numpy array as it is."""
    if isinstance(array, MdArray):
        array = array.data
    if isinstance(array, torch.Tensor):
        # C order, as the reference's device arrays always are
        t = array.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).view(
                _BF16_WIRE)
        return t.numpy()
    arr = np.asarray(array)
    if arr.dtype.name == "bfloat16":
        arr = np.ascontiguousarray(arr).view(np.uint16).view(_BF16_WIRE)
    return arr


def serialize_mdspan(res, stream: BinaryIO, array: Any) -> None:
    """Write an array or tensor (host or device) in ``.npy`` format."""
    np.save(stream, host_array(array), allow_pickle=False)


def deserialize_mdspan(res, stream: BinaryIO, to_device: bool = True):
    """Read a ``.npy`` stream back: a tensor on the handle's device
    (``cuda:0`` by default) when ``to_device``, else a numpy array (a
    bf16 stream as a CPU ``torch.bfloat16`` tensor)."""
    arr = np.load(stream, allow_pickle=False)
    if arr.dtype.names == ("bfloat16",):
        t = torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
        return t.to(get_device(default_resources(res))) if to_device else t
    if to_device:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            get_device(default_resources(res)))
    return arr


def serialize_scalar(res, stream: BinaryIO, value) -> None:
    np.save(stream, np.asarray(value), allow_pickle=False)


def deserialize_scalar(res, stream: BinaryIO):
    """Read a scalar back as the native Python value."""
    val = np.load(stream, allow_pickle=False)[()]
    return val.item() if isinstance(val, np.generic) else val


def dumps(array: Any) -> bytes:
    buf = io.BytesIO()
    serialize_mdspan(None, buf, array)
    return buf.getvalue()


def loads(data: Union[bytes, bytearray], to_device: bool = True,
          res: Optional[Resources] = None):
    return deserialize_mdspan(res, io.BytesIO(bytes(data)), to_device)
