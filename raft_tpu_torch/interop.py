"""Carry state across from the reference package.

The reference package's arrays arrive as numpy (``np.asarray`` of a JAX
array); :func:`from_numpy` turns them into the port's tensors on a given
device, bf16 arrays bit for bit. This covers data, centroids and the
``lloyd_prepare`` operands ``(xh, xl, xn)``, so both packages can be
handed the same operand bytes. :func:`kmeans_params_from_dict` builds
:class:`~raft_tpu_torch.cluster.kmeans.KMeansParams` from a plain dict
(for example ``dataclasses.asdict`` of the reference's params).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from raft_tpu_torch.cluster.kmeans import KMeansInit, KMeansParams

__all__ = ["from_numpy", "kmeans_params_from_dict"]


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
