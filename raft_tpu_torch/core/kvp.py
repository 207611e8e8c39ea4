"""Key-value pair of the arg-reductions (counterpart of
``raft_tpu/core/kvp.py``): a pair of tensors (keys, values), reduced by
``core.operators.argmin_op``/``argmax_op`` with the reference's tie rule
(the smaller key wins on equal values)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from raft_tpu_torch.core.resources import as_tensor


class KeyValuePair(NamedTuple):
    key: torch.Tensor
    value: torch.Tensor


def make_kvp(keys, values) -> KeyValuePair:
    """Both halves as tensors; a non-tensor goes to ``cuda:0``, as every
    entry point's arrays do."""
    return KeyValuePair(as_tensor(keys), as_tensor(values))
