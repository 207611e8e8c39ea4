"""Spectral partitioning and modularity clustering on one device
(counterpart of ``raft_tpu/spectral/partition.py``).

The pipeline is the reference's: Laplacian (``sparse.linalg``), smallest
eigenpairs by thick-restart Lanczos (``sparse.solver``, SpMV on
csrc/csr_spmv.cu), row-normalized embedding, k-means (``cluster``, the
fused Lloyd kernel csrc/fused_lloyd.cu). k-means++ draws from a
``torch.Generator``, so labels match the reference's up to a
permutation. The ``mesh=`` pipeline needs the comms port (ROADMAP.md,
queue A item 7).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster.kmeans import KMeansParams, kmeans_fit
from raft_tpu_torch.core.sparse_types import COOMatrix, CSRMatrix
from raft_tpu_torch.sparse import convert, op
from raft_tpu_torch.sparse.linalg import (csr_row_norm, laplacian,
                                          laplacian_normalized)
from raft_tpu_torch.sparse.solver.lanczos import (LanczosConfig,
                                                  lanczos_compute_eigenpairs)

__all__ = ["partition", "modularity_maximization"]


def _as_csr(a, res=None) -> CSRMatrix:
    """A CSRMatrix; a COOMatrix is sorted and converted, and a scipy
    matrix goes to the handle's device."""
    if isinstance(a, COOMatrix):
        return convert.sorted_coo_to_csr(op.coo_sort(a))
    if isinstance(a, CSRMatrix):
        return a
    return CSRMatrix.from_scipy(a, res=res)


def _embedding(vecs: torch.Tensor) -> torch.Tensor:
    """Ng–Jordan–Weiss: rows scaled to unit norm."""
    norms = torch.linalg.vector_norm(vecs, dim=1, keepdim=True)
    return (vecs / torch.clamp_min(norms, 1e-12)).to(torch.float32)


def partition(res, graph, n_clusters: int, n_eig_vects: int = 0,
              normalized: bool = True, ncv: int = 0,
              max_iterations: int = 200, tolerance: float = 1e-4,
              seed: int = 0, mesh=None, data_axis: str = "data",
              return_report: bool = False) -> Tuple[torch.Tensor, ...]:
    """Spectral partition of an undirected graph (CSR, COO or scipy
    adjacency): ``(clusters [n], eigenvalues [k], eigenvectors [n, k])``
    from the ``n_eig_vects`` (default ``n_clusters``) smallest
    eigenvectors of the (normalized) Laplacian, and the eigensolve's
    :class:`ConvergenceReport` last with ``return_report=True``."""
    if mesh is not None:
        raise NotImplementedError(
            "partition(mesh=...) runs eigsh_mnmg and kmeans_fit_mnmg, which "
            "need the comms port (ROADMAP.md, queue A item 7)")
    csr = _as_csr(graph, res)
    lap = laplacian_normalized(csr) if normalized else laplacian(csr)
    cfg = LanczosConfig(n_components=n_eig_vects or n_clusters,
                        max_iterations=max_iterations, ncv=ncv,
                        tolerance=tolerance, which="SA", seed=seed)
    vals, vecs, report = lanczos_compute_eigenpairs(res, lap, cfg,
                                                    return_report=True)
    _, _, labels, _ = kmeans_fit(
        res, KMeansParams(n_clusters=n_clusters, seed=seed),
        _embedding(vecs))
    return (labels, vals, vecs, report) if return_report else (labels, vals,
                                                                vecs)


def modularity_maximization(res, graph, n_clusters: int,
                            n_eig_vects: int = 0, ncv: int = 0,
                            max_iterations: int = 200,
                            tolerance: float = 1e-4, seed: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """k-means on the LARGEST eigenvectors of the modularity matrix
    B = A − d·dᵀ/2m, applied matrix-free as A plus a rank-1 term inside
    the Lanczos operator."""
    csr = _as_csr(graph, res)
    cfg = LanczosConfig(n_components=n_eig_vects or n_clusters,
                        max_iterations=max_iterations, ncv=ncv,
                        tolerance=tolerance, which="LA", seed=seed)
    deg = csr_row_norm(csr, "l1")
    two_m = max(float(torch.sum(deg)), 1e-12)
    vals, vecs = lanczos_compute_eigenpairs(
        res, csr, cfg, rank1=(deg, deg, np.float32(-1.0 / two_m)))
    _, _, labels, _ = kmeans_fit(
        res, KMeansParams(n_clusters=n_clusters, seed=seed),
        _embedding(vecs))
    return labels, vals, vecs
