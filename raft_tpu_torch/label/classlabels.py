"""Class-label utilities (counterpart of ``raft_tpu/label/classlabels.py``).

The unique labels come from ``torch.unique(sorted=True)`` on the labels'
device (the reference takes ``np.unique`` on the host: the same sorted
set, without the host hop), and the relabeling is one
``torch.searchsorted`` against them. A tensor runs on its device, an
array goes to the process-wide handle's (``cuda:0``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from raft_tpu_torch.core.resources import as_tensor


def get_unique_labels(labels):
    """The sorted unique labels."""
    return torch.unique(as_tensor(labels), sorted=True)


def get_ovr_labels(labels, unique_labels, idx: int):
    """One-vs-rest: +1 where the label is ``unique_labels[idx]``, else
    -1, in the labels' dtype."""
    n_classes = unique_labels.shape[0]
    if idx >= n_classes:
        raise ValueError(
            f"idx ({idx}) must be < number of classes ({n_classes})")
    labels = as_tensor(labels)
    target = torch.as_tensor(unique_labels, device=labels.device)[idx]
    one = torch.ones((), dtype=labels.dtype, device=labels.device)
    return torch.where(labels == target, one, -one)


def make_monotonic(labels, filter_op: Optional[Callable] = None,
                   zero_based: bool = False):
    """Each label's rank among the unique labels, from 1 (from 0 with
    ``zero_based``), in the labels' dtype. Labels for which
    ``filter_op`` is True pass through unchanged (they still count among
    the unique labels, as in the reference)."""
    labels = as_tensor(labels)
    uniq = get_unique_labels(labels)
    ranks = torch.searchsorted(uniq, labels.contiguous()) + (
        0 if zero_based else 1)
    ranks = ranks.to(labels.dtype)
    if filter_op is not None:
        return torch.where(filter_op(labels), labels, ranks)
    return ranks
