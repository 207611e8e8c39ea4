"""Partition quality analyzers (counterpart of
``raft_tpu/spectral/analyzers.py``).

All clusters are evaluated at once: the quadratic forms x_iᵀ L x_i are the
diagonal of Hᵀ L H for the one-hot membership matrix H [n, k], so the
work is one SpMM (A·H, ``sparse.linalg.spmm``: csrc/csr_spmm.cu on the
card) and one SpMV for the degrees (A·1, csrc/csr_spmv.cu). The
reference's scatter-add ``_spmm`` computes the same product.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.core.sparse_types import COOMatrix, CSRMatrix
from raft_tpu_torch.sparse import convert, linalg, op
from raft_tpu_torch.util.precision import with_matmul_precision

__all__ = ["analyze_partition", "analyze_modularity"]


def _csr(a) -> CSRMatrix:
    if isinstance(a, COOMatrix):
        return convert.sorted_coo_to_csr(op.coo_sort(a))
    return a


def _membership(clusters, n_clusters: int, dtype, res):
    """One-hot [n, k] of the labels."""
    clusters = as_tensor(clusters, res).to(torch.int64)
    return (clusters[:, None] == torch.arange(
        n_clusters, device=clusters.device)[None, :]).to(dtype)


def _ah_and_degree(csr: CSRMatrix, h):
    ah = linalg.spmm(csr, h)                                  # [n, k]
    deg = linalg.spmm(csr, torch.ones((csr.n_rows, 1), dtype=h.dtype,
                                      device=h.device))[:, 0]
    return ah, deg


@with_matmul_precision
def analyze_partition(res, csr, n_clusters: int, clusters):
    """``(edge_cut, cost)`` of a clustering of a weighted undirected
    graph: edge_cut = Σ x_iᵀ L x_i / 2, cost the ratio cut
    Σ x_iᵀ L x_i / |cluster_i| over non-empty clusters."""
    csr = _csr(csr)
    h = _membership(clusters, n_clusters, csr.data.dtype, res)
    ah, deg = _ah_and_degree(csr, h)
    quad = torch.sum(h * (deg[:, None] * h - ah), dim=0)     # x_iᵀ L x_i
    sizes = torch.sum(h, dim=0)
    edge_cut = torch.sum(quad) / 2.0
    cost = torch.sum(torch.where(sizes > 0,
                                 quad / torch.clamp_min(sizes, 1), 0.0))
    return edge_cut, cost


@with_matmul_precision
def analyze_modularity(res, csr, n_clusters: int, clusters):
    """Modularity Σ_i x_iᵀ B x_i / ‖d‖₁, B x = A x − (dᵀx / ‖d‖₁) d."""
    csr = _csr(csr)
    h = _membership(clusters, n_clusters, csr.data.dtype, res)
    ah, deg = _ah_and_degree(csr, h)
    two_m = torch.sum(deg)
    dtx = deg @ h                                             # [k]
    bh = ah - (dtx[None, :] / two_m) * deg[:, None]
    return torch.sum(torch.sum(h * bh, dim=0)) / two_m
