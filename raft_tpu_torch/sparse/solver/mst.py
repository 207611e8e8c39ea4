"""Borůvka minimum spanning tree / forest (counterpart of
``raft_tpu/sparse/solver/mst.py``).

Each round runs on the device:

- the E-stage (``mst_grid.per_vertex_min_edge``, CUDA kernel
  ``csrc/mst_min_edge.cu``) gives every vertex its cheapest
  cross edge as ``(w, key, eid)``, ``key`` the canonical undirected pair
  ``min(u, v) * n_cols + max(u, v)``, a strict total order on undirected
  edges;
- a V-sized lexicographic cascade over colors (``scatter_reduce`` with
  ``"amin"``; a min is exact in any order) picks each color's edge;
- mutual picks of one undirected edge are deduped by key equality,
  keeping the smaller color's;
- colors merge by gather-only pointer doubling, ``ceil(log2 n)`` steps of
  ``f = f[f]``;
- one host poll of the included count ends the round (none left: done).

**One route.** The reference has two E-stages, its XLA round (with edge
compaction) and its slot-grid Pallas round, chosen by ``RAFT_TPU_MST`` and
a size gate. Both give the same forest and colors, and so does this
module. It reads no ``RAFT_TPU_MST`` and has no gate: a CUDA CSR goes to
the kernel, a CPU CSR to the kernel's plain version. Edge filtering (a
mask of edges still crossing, since the kernel walks CSR rows) is a later
performance lever. Deadlines (``runtime.limits``) are not ported
(ROADMAP.md queue A item 13).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core.sparse_types import CSRMatrix
from raft_tpu_torch.sparse.solver.mst_grid import (_seg_lex_min,
                                                   per_vertex_min_edge,
                                                   prepare_mst)

__all__ = ["GraphCOO", "mst"]


@dataclasses.dataclass
class GraphCOO:
    """The forest: ``src``, ``dst`` (int32), ``weights`` (the graph's
    dtype) and the number of directed edges ``n_edges``."""
    src: torch.Tensor
    dst: torch.Tensor
    weights: torch.Tensor
    n_edges: int


def _merge_colors(colors, has_edge, other, cid, n: int):
    """Merge supervertices by gather-only pointer doubling. Under the
    strict total order on undirected edges, the chosen-edge functional
    graph ``f(c) = other(c)`` has exactly one cycle per component, the
    mutual 2-cycle at its minimum edge; ``ceil(log2 n)`` doublings land
    every color in it, and ``min(f^K(c), f(f^K(c)))`` labels the
    component."""
    f0 = torch.where(has_edge, other, cid)
    fk = f0
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        fk = fk[fk]
    return torch.minimum(fk, f0[fk])[colors.long()].to(torch.int32)


def _color_stage(colors, plan, n: int, vw, vk, ve):
    """The V-sized rest of a round, from the vertices' cheapest cross
    edges ``(vw, vk, ve)``: ``(new_colors, seg_e, include, n_included)``,
    where ``seg_e[c]`` is color c's chosen edge id (junk unless
    ``include[c]``)."""
    cid = torch.arange(n, device=colors.device)
    seg_w, seg_k, seg_e = _seg_lex_min(vw, (vk, ve), colors.long(), n)
    has_edge = seg_w < float("inf")
    safe_e = torch.where(has_edge, seg_e, 0).long()
    other = torch.where(has_edge, colors[plan.indices[safe_e].long()].long(),
                        cid)
    my_key = torch.where(has_edge, seg_k, -1)
    mutual = has_edge & has_edge[other] & (my_key[other] == my_key)
    include = has_edge & (~mutual | (cid < other))
    new_colors = _merge_colors(colors, has_edge, other, cid, n)
    return new_colors, seg_e, include, include.sum()


def _boruvka_round(colors, plan, n: int, e_stage=per_vertex_min_edge):
    """One round: the E-stage, then :func:`_color_stage`."""
    return _color_stage(colors, plan, n, *e_stage(plan, colors))


def _solve(plan, colors, e_stage=per_vertex_min_edge):
    """Borůvka rounds from ``colors`` until none includes an edge (at
    most ``ceil(log2 n) + 1``): ``(colors, edge_mask over the logical
    edges, rounds)``. ``e_stage`` is the E-stage (a test may pass the
    kernel's plain version to run it on CUDA tensors)."""
    n = plan.n
    edge_mask = torch.zeros(plan.n_edges, dtype=torch.bool,
                            device=plan.device)
    rounds = 0
    for _ in range(max(1, math.ceil(math.log2(max(n, 2)))) + 1):
        colors, seg_e, include, n_incl = _boruvka_round(colors, plan, n,
                                                        e_stage)
        rounds += 1
        if not int(n_incl):              # the round's single host poll
            break
        edge_mask = _accumulate(edge_mask, seg_e, include)
    return colors, edge_mask, rounds


def _accumulate(edge_mask, seg_e, include):
    edge_mask[seg_e[include].long()] = True
    return edge_mask


def _forest_output(plan, edge_mask, symmetrize_output: bool) -> GraphCOO:
    """The chosen edges in ascending edge id (CSR position), then
    ``[s, d] ++ [d, s]`` when symmetrized."""
    ids = torch.nonzero(edge_mask)[:, 0]
    s = (torch.searchsorted(plan.indptr, ids.to(plan.indptr.dtype),
                            right=True) - 1).to(torch.int32)
    d = plan.indices[ids]
    w = plan.data[ids]
    if symmetrize_output:
        s, d, w = torch.cat([s, d]), torch.cat([d, s]), torch.cat([w, w])
    return GraphCOO(s, d, w, int(s.shape[0]))


def mst(res, csr, color: Optional[np.ndarray] = None,
        symmetrize_output: bool = True) -> GraphCOO:
    """MST/MSF of an undirected graph in CSR form (the input is expected
    symmetric, as in the reference). Returns the forest as
    :class:`GraphCOO` on the CSR's device, edges in CSR-position order.
    ``color`` (a numpy array of length V, values in ``[0, V)``), if given,
    seeds the supervertex labels and is updated in place with the final
    ones. A scipy matrix goes to ``res``'s device (``cuda:0`` by default);
    a CSRMatrix runs on its own device."""
    if not isinstance(csr, CSRMatrix):
        csr = CSRMatrix.from_scipy(csr, res=res)
    plan = prepare_mst(csr)
    colors = (torch.arange(csr.n_rows, dtype=torch.int32, device=plan.device)
              if color is None else
              torch.as_tensor(np.asarray(color, dtype=np.int32),
                              device=plan.device))
    colors, edge_mask, _ = _solve(plan, colors)
    if color is not None:
        color[:] = colors.cpu().numpy()
    return _forest_output(plan, edge_mask, symmetrize_output)
