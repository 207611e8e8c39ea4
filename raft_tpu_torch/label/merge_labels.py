"""Union-find label merging (counterpart of
``raft_tpu/label/merge_labels.py``).

Two labelings A and B of points 0..N-1 are merged: where ``mask`` holds,
labels a_i and b_i are equivalent, and every group takes the smallest
label equivalent to it. A representative map r over the labels 1..N
(slot 0 scratch) reaches the reference's fixed point by rounds of
scatter-min propagation (``scatter_reduce_(..., "amin")`` from both
sides of every masked pair) and path halving (``r = min(r, r[r])``),
the original CUDA design: the host reads one change flag a round. The
reference keeps the loop on the device (``lax.while_loop``), which torch
has no equivalent of without graphs (ROADMAP.md, queue A item 13b). The
cap is the reference's diameter-safe ``N + 2`` rounds: an adversarial
chain moves its minimum one hop a round.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core import trace
from raft_tpu_torch.core.resources import as_tensor

# the unlabelled sentinel (int32 max, as the reference's)
MAX_LABEL = 2 ** 31 - 1


def _round(r, safe_a, safe_b, mask):
    """One propagation round and one path-halving step, out of place."""
    lo = torch.minimum(r[safe_a], r[safe_b])
    upd = torch.where(mask, lo, torch.full_like(lo, MAX_LABEL))
    r = r.scatter_reduce(0, safe_a, upd, "amin")
    r = r.scatter_reduce_(0, safe_b, upd, "amin")
    r[1:] = torch.minimum(r[1:], r[r[1:]])
    return r


def _merge_fixpoint(labels_a, labels_b, mask, max_rounds: int):
    """``(r, rounds)``: the representative map (int64, N + 1 slots)
    after full propagation, and the rounds after the first whose change
    flag was read, as the reference's loop counts them."""
    n = labels_a.shape[0]
    zero = torch.zeros((), dtype=torch.int64, device=labels_a.device)
    safe_a = torch.where(mask, labels_a.long(), zero)
    safe_b = torch.where(mask, labels_b.long(), zero)
    r = _round(torch.arange(n + 1, device=labels_a.device), safe_a, safe_b,
               mask)
    rounds = 0
    while rounds < max_rounds:
        nr = _round(r, safe_a, safe_b, mask)
        rounds += 1
        changed = bool(torch.any(nr != r))
        r = nr
        if not changed:
            break
    return r, rounds


def merge_labels(labels_a, labels_b, mask):
    """The merged labels (a new tensor, in ``labels_a``'s dtype; the
    reference updates labels_a in place). Labels take values 1..N, and
    ``MAX_LABEL`` marks an unlabelled point, which passes through; a
    masked point must carry labels in 1..N on both sides, else
    ``ValueError``. Records a ``label.merge_labels`` event with the
    rounds run, the first included."""
    a0 = as_tensor(labels_a)
    a = a0.long()
    b = as_tensor(labels_b).to(a.device).long()
    mask = as_tensor(mask).to(device=a.device, dtype=torch.bool)
    n = a.shape[0]
    both = torch.stack([a[mask], b[mask]])
    if both.numel() and bool(((both < 1) | (both > n)).any()):
        raise ValueError(f"merge_labels: a masked point has a label "
                         f"outside 1..{n}")
    r, rounds = _merge_fixpoint(a, b, mask, n + 2)
    trace.record_event("label.merge_labels", rows=n, rounds=rounds + 1)
    unlabelled = a == MAX_LABEL
    out = torch.where(unlabelled, a,
                      r[torch.where(unlabelled, torch.zeros_like(a), a)])
    return out.to(a0.dtype)
