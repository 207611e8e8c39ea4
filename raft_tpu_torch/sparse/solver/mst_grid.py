"""Borůvka E-stage on the card (counterpart of
``raft_tpu/sparse/solver/mst_grid.py``): each vertex's cheapest cross
edge under a coloring.

CUDA kernel ``csrc/mst_min_edge.cu``, beside its plain version
:func:`_min_edge_plain`. It replaces the reference's ``_mst_scan_kernel``,
``_mst_reduce_kernel`` and its ``_tree_gather_kernel`` reuse for
``colors[dst]``. Those pack the edges into a slot grid and order
undirected edges by a host-built ``rank`` array (an ``np.unique`` over all
canonical pairs), because Mosaic's gathers are lane-local. ``rank`` is
only the position of ``(min(u, v), max(u, v))`` in sorted order, so the
int64 key ``min(u, v) * n_cols + max(u, v)`` gives the same order; the
kernel reads ``colors[u]`` and ``colors[v]`` straight from the CSR arrays.
So :func:`prepare_mst` builds no rank, no slot grid and no host pass: the
plan is the CSR arrays on their device and csr_spmv's split of the work
(``grid_spmv``): lane groups of :func:`~raft_tpu_torch.sparse.grid_spmv.
_spmv_lanes` lanes take short rows and long rows' heads, a warp a chunk of
:data:`~raft_tpu_torch.sparse.grid_spmv.SPMV_SEG` entries long rows'
tails, named by :func:`~raft_tpu_torch.sparse.grid_spmv._spmv_owners`
once per graph, since the pattern does not change across rounds.

Per vertex u the result is the lexicographic minimum over u's stored
entries j with ``colors[u] != colors[indices[j]]`` of ``(data[j], key,
j)``, the order of the reference's ``(w, rank, eid)`` and of its XLA
round's ``(w, a, b, eid)``; the identity ``(+inf, INT64_MAX, INT32_MAX)``
where u has no cross edge. Edge ids are CSR positions; a bucketed CSR's
pad entries (past ``indptr[-1]``) are never read. Weights must not be
NaN.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch import kernels
from raft_tpu_torch.sparse.grid_spmv import (SPMV_SEG, _spmv_lanes,
                                             _spmv_owners)

__all__ = ["MSTPlan", "prepare_mst", "per_vertex_min_edge"]

KEY_MAX = torch.iinfo(torch.int64).max
EID_MAX = torch.iinfo(torch.int32).max
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


class MSTPlan:
    """The E-stage's view of one graph: the CSR arrays on their device
    (``indices`` int32), the vertex count, ``n_cols`` (the key's
    multiplier) and the logical edge count; and the kernel's split of the
    work, made here once from the pattern with torch ops on its device (no
    host sync): ``owners`` (int32, the row whose tail meets each chunk of
    :data:`SPMV_SEG` physical entries, or -1) and ``lanes`` (lanes a short
    row)."""

    def __init__(self, *, indptr, indices, data, n: int, n_cols: int,
                 n_edges: int):
        self.indptr = indptr
        self.indices = indices
        self.data = data
        self.n = n
        self.n_cols = n_cols
        self.n_edges = n_edges
        self.owners = (_spmv_owners(indptr, indices.numel()) if n
                       else None)
        self.lanes = _spmv_lanes(indices.numel(), n)

    @property
    def device(self) -> torch.device:
        return self.data.device


def prepare_mst(csr) -> MSTPlan:
    """The plan of a (symmetric) CSRMatrix: its arrays as they are, with
    ``indices`` made int32 where it is not. No host pass."""
    if csr.n_cols >= 1 << 31:
        raise ValueError(f"{csr.n_cols} columns do not fit int32 indices")
    if csr.dtype not in _DTYPE_CODE:
        raise TypeError(f"weights must be f32 or f64, got {csr.dtype}")
    if csr.indptr.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"indptr must be int32 or int64, got "
                        f"{csr.indptr.dtype}")
    n_edges = csr.logical_nnz()
    if n_edges >= 1 << 31:
        raise ValueError(f"{n_edges} edges do not fit int32 edge ids")
    return MSTPlan(indptr=csr.indptr.contiguous(),
                   indices=csr.indices.to(torch.int32).contiguous(),
                   data=csr.data.contiguous(), n=csr.n_rows,
                   n_cols=max(csr.n_cols, 1), n_edges=n_edges)


def _seg_lex_min(lead, keys, seg, n: int):
    """Per-segment lexicographic minimum by cascade over int64 segment ids
    ``seg``: ``lead`` (float, +inf identity) first, then each int key (its
    dtype's max as identity) among the survivors; a min is exact in any
    order. Returns the reduced lead and each key's winner, in order. The
    E-stage's plain version reduces per row with it, the round per
    color."""
    seg_lead = torch.full((n,), float("inf"), dtype=lead.dtype,
                          device=lead.device).scatter_reduce(
        0, seg, lead, "amin")
    sel = lead == seg_lead[seg]
    outs = [seg_lead]
    for key in keys:
        ident = torch.iinfo(key.dtype).max
        masked = torch.where(sel, key, ident)
        seg_k = torch.full((n,), ident, dtype=key.dtype,
                           device=key.device).scatter_reduce(
            0, seg, masked, "amin")
        sel &= key == seg_k[seg]
        outs.append(seg_k)
    return outs


def _min_edge_plain(indptr, indices, data, colors, n_cols: int,
                    n_rows: int):
    """The E-stage as E-sized torch ops over the logical entries: the
    cross mask, the three keys, then a per-row lexicographic cascade."""
    nnz = int(indptr[-1])
    lengths = (indptr[1:] - indptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=indptr.device), lengths,
        output_size=nnz)
    cols = indices[:nnz].long()
    cross = colors[rows] != colors[cols]
    w = torch.where(cross, data[:nnz], float("inf"))
    key = torch.where(cross, torch.minimum(rows, cols) * n_cols
                      + torch.maximum(rows, cols), KEY_MAX)
    eid = torch.where(cross, torch.arange(nnz, dtype=torch.int32,
                                          device=indptr.device), EID_MAX)
    return tuple(_seg_lex_min(w, (key, eid), rows, n_rows))


def _min_edge(plan: MSTPlan, colors: torch.Tensor):
    """``(minw [n], minkey [n] int64, mineid [n] int32)``:
    csrc/mst_min_edge.cu on CUDA, the plain version on the CPU."""
    dev = plan.device
    if colors.device != dev or colors.dtype != torch.int32:
        raise TypeError(f"colors must be int32 on {dev}, got "
                        f"{colors.dtype} on {colors.device}")
    if dev.type == "cpu":
        return _min_edge_plain(plan.indptr, plan.indices, plan.data, colors,
                               plan.n_cols, plan.n)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = plan.n
    w = torch.empty(n, dtype=plan.data.dtype, device=dev)
    key = torch.empty(n, dtype=torch.int64, device=dev)
    eid = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        # one chunk warp (and partial) per SPMV_SEG physical entries
        n_chunks = plan.owners.numel()
        part_w = torch.empty(n_chunks, dtype=plan.data.dtype, device=dev)
        part_key = torch.empty(n_chunks, dtype=torch.int64, device=dev)
        part_eid = torch.empty(n_chunks, dtype=torch.int32, device=dev)
        kernels.launch("mst_min_edge", dev, _DTYPE_CODE[plan.data.dtype],
                       int(plan.indptr.dtype == torch.int64),
                       plan.indptr.data_ptr(), plan.indices.data_ptr(),
                       plan.data.data_ptr(), colors.contiguous().data_ptr(),
                       plan.n_cols, w.data_ptr(), key.data_ptr(),
                       eid.data_ptr(), n, n_chunks, SPMV_SEG, plan.lanes,
                       plan.owners.data_ptr(), part_w.data_ptr(),
                       part_key.data_ptr(), part_eid.data_ptr())
    return w, key, eid


def per_vertex_min_edge(csr_or_plan, colors
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-vertex cheapest cross edge under ``colors`` as lexicographic
    ``(w, key, eid)`` triples: ``(minw [n], minkey [n] int64, mineid [n]
    int32)``, the identity ``(+inf, INT64_MAX, INT32_MAX)`` where a vertex
    has no cross edge. Takes a CSRMatrix or its :class:`MSTPlan`; a
    non-tensor ``colors`` goes to the graph's device. CUDA kernel:
    ``csrc/mst_min_edge.cu``."""
    plan = (csr_or_plan if isinstance(csr_or_plan, MSTPlan)
            else prepare_mst(csr_or_plan))
    if not isinstance(colors, torch.Tensor):
        colors = torch.as_tensor(np.asarray(colors), device=plan.device)
    return _min_edge(plan, colors.to(plan.device, torch.int32))
