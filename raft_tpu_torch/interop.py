"""Carry state across from the reference package.

The reference package's arrays arrive as numpy (``np.asarray`` of a JAX
array); :func:`from_numpy` turns them into the port's tensors on the
handle's device (``cuda:0`` by default), bf16 arrays bit for bit. This
covers data, centroids and the ``lloyd_prepare`` operands ``(xh, xl,
xn)``, so both packages can be handed the same operand bytes.
:func:`csr_from_numpy` does the same for a reference CSR matrix's arrays,
padding included, on the handle's device.
:func:`kmeans_params_from_dict` and :func:`lanczos_config_from_dict`
build the port's parameter objects from a plain dict (for example
``dataclasses.asdict`` of the reference's).
:func:`mdarray_from_numpy`, :func:`device_cache_state_from_numpy` and
:func:`lap_costs_from_numpy` carry an ``MdArray`` (with its memory type
and layout), a device cache's state and a LAP's cost batch.
:func:`streaming_index_from_entries` turns a reference streaming index's
epoch entries (``streaming._epoch_entries``) into the port's
``StreamingIndex``; a journal directory needs nothing, since each
package recovers the other's files.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from raft_tpu_torch.cluster.kmeans import KMeansInit, KMeansParams
from raft_tpu_torch.core.mdarray import ROW_MAJOR, MdArray, pinned
from raft_tpu_torch.core.memory_type import MemoryType
from raft_tpu_torch.core.resources import (DeviceResources, as_tensor,
                                           default_resources, get_device)
from raft_tpu_torch.core.sparse_types import CSRMatrix
from raft_tpu_torch.sparse.solver.lanczos import LanczosConfig
from raft_tpu_torch.util.cache import DeviceCacheState

__all__ = ["from_numpy", "kmeans_params_from_dict", "csr_from_numpy",
           "lanczos_config_from_dict", "mdarray_from_numpy",
           "device_cache_state_from_numpy", "lap_costs_from_numpy",
           "streaming_index_from_entries"]


def from_numpy(a, res=None, device=None):
    """numpy array (or a tuple/list of them) -> tensor(s) on the handle's
    device (``cuda:0`` by default, which raises without CUDA); an
    explicit ``device`` wins over the handle.

    bf16 arrays (numpy dtype named ``bfloat16``) go through a 16-bit
    integer view, so every bit is kept; other dtypes keep their dtype."""
    if isinstance(a, (tuple, list)):
        return type(a)(from_numpy(t, res, device) for t in a)
    if device is not None:
        res = DeviceResources(device)
    a = np.array(a)          # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return as_tensor(a.view(np.int16), res).view(torch.bfloat16)
    return as_tensor(a, res)


def kmeans_params_from_dict(d: Mapping) -> KMeansParams:
    """:class:`KMeansParams` from a plain dict. ``init`` may be a
    :class:`KMeansInit`, its value (``"array"``), its name
    (``"ARRAY"``), or any enum whose value is one of those."""
    fields = dict(d)
    init = fields.get("init", KMeansInit.KMEANS_PLUS_PLUS)
    if not isinstance(init, KMeansInit):
        raw = getattr(init, "value", init)
        by_name = {e.name: e for e in KMeansInit}
        init = by_name[raw] if raw in by_name else KMeansInit(raw)
    fields["init"] = init
    return KMeansParams(**fields)


def csr_from_numpy(indptr, indices, data, shape, logical_nnz:
                   Optional[int] = None, res=None) -> CSRMatrix:
    """A port CSRMatrix from a reference matrix's arrays (as numpy) on the
    handle's device (``cuda:0`` by default), with the same physical nnz
    (``len(indices)``, pads included) and logical nnz (``indptr[-1]``, or
    ``logical_nnz`` where given)."""
    out = CSRMatrix(*(as_tensor(np.array(a), res)
                      for a in (indptr, indices, data)), shape)
    out._logical_nnz_hint = (int(np.asarray(indptr)[-1])
                             if logical_nnz is None else int(logical_nnz))
    return out


def lanczos_config_from_dict(d: Mapping) -> LanczosConfig:
    """:class:`LanczosConfig` from a plain dict of its fields."""
    return LanczosConfig(**dict(d))


def mdarray_from_numpy(data, memory_type, layout: str = ROW_MAJOR,
                       res=None) -> MdArray:
    """A port MdArray from a reference MdArray's buffer (as numpy), its
    memory type (either package's ``MemoryType``, or its value such as
    ``"pinned"``) and its layout; the buffer is kept as it is (a
    ``COL_MAJOR`` buffer holds Aᵀ). Device-accessible types land on the
    handle's device, ``PINNED`` in page-locked host memory."""
    mt = MemoryType(getattr(memory_type, "value", memory_type))
    t = from_numpy(data, device="cpu")
    if mt.is_device_accessible:
        t = t.to(get_device(default_resources(res)))
    elif mt is MemoryType.PINNED:
        t = pinned(t)
    return MdArray(t, mt, str(layout))


def device_cache_state_from_numpy(keys, time, store, clock,
                                  res=None) -> DeviceCacheState:
    """A port DeviceCacheState from a reference state's ``keys``,
    ``time``, ``store`` and ``clock`` (as numpy) on the handle's
    device."""
    k, t, st, c = from_numpy((keys, time, store, clock), res)
    return DeviceCacheState(k.to(torch.int32).contiguous(),
                            t.to(torch.int32).contiguous(),
                            st.contiguous(), c.to(torch.int32).reshape(()))


def lap_costs_from_numpy(cost, res=None) -> torch.Tensor:
    """A LAP's cost batch [B, n, n] (an [n, n] matrix gains the batch
    axis) on the handle's device, dtype kept."""
    t = from_numpy(cost, res)
    return t[None] if t.ndim == 2 else t


def streaming_index_from_entries(entries: Mapping, res=None, *, log=None,
                                 faults=None, drift=None,
                                 repack_slack: Optional[int] = None):
    """A reference streaming index's epoch entries (the numpy dict of
    ``raft_tpu.neighbors.streaming._epoch_entries``, or an epoch file's
    ``restore_checkpoint``) as the port's
    :class:`~raft_tpu_torch.neighbors.streaming.StreamingIndex` on the
    handle's device: the same packing, tombstones, ids, horizon and term,
    so the same ``content_crc()`` and search bits. With a ``log``
    (a :class:`~raft_tpu_torch.neighbors.streaming.MutationLog`) the state
    is written there as an epoch snapshot and the WAL cursor moves past
    the horizon."""
    from raft_tpu_torch.neighbors import streaming

    flat = streaming._flat_from_entries(
        entries, get_device(default_resources(res)))
    kw = {} if repack_slack is None else {"repack_slack": repack_slack}
    idx = streaming.StreamingIndex(
        flat, log=log, faults=faults, res=res, drift=drift,
        epoch=int(entries["epoch"]), next_id=int(entries["next_id"]),
        tomb_host=np.asarray(entries["tomb_words"], np.uint32),
        n_live=int(entries["n_live"]),
        term=int(entries.get("wal_term", 0)), **kw)
    idx._term_start = int(entries.get("wal_term_start", 0))
    idx._applied_seq = int(entries.get("wal_horizon", -1))
    if log is not None:
        log.bump_seq(idx._applied_seq + 1)
        with idx._lock:
            idx._write_epoch_locked(crash=False)
    return idx
