"""Carry state across from the reference package.

The reference package's arrays arrive as numpy (``np.asarray`` of a JAX
array); :func:`from_numpy` turns them into the port's tensors on a given
device, bf16 arrays bit for bit. This covers data, centroids and the
``lloyd_prepare`` operands ``(xh, xl, xn)``, so both packages can be
handed the same operand bytes. :func:`csr_from_numpy` does the same for a
reference CSR matrix's arrays, padding included, on the handle's device.
:func:`kmeans_params_from_dict` and :func:`lanczos_config_from_dict`
build the port's parameter objects from a plain dict (for example
``dataclasses.asdict`` of the reference's).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from raft_tpu_torch.cluster.kmeans import KMeansInit, KMeansParams
from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.core.sparse_types import CSRMatrix
from raft_tpu_torch.sparse.solver.lanczos import LanczosConfig

__all__ = ["from_numpy", "kmeans_params_from_dict", "csr_from_numpy",
           "lanczos_config_from_dict"]


def from_numpy(a, device="cpu"):
    """numpy array (or a tuple/list of them) -> tensor(s) on ``device``.

    bf16 arrays (numpy dtype named ``bfloat16``) go through a 16-bit
    integer view, so every bit is kept; other dtypes keep their dtype."""
    if isinstance(a, (tuple, list)):
        return type(a)(from_numpy(t, device) for t in a)
    a = np.array(a)          # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


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
