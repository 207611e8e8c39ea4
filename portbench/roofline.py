"""The yardstick's peaks and its counts of operations and bytes.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates. A bound is
the least time the card could take for the work the cell's inputs need,
whatever implements it: the larger of the operations over their peak and
the bytes over HBM bandwidth, each input byte read once and each output
byte written once. Operations follow the precision tier: at 'high'
(bf16x3) a product of an m x d and a d x n float32 block is three bf16
products, 3 * 2 * m * n * d operations at the bf16 peak; at 'default'
one; at 'highest' one float32 product at the CUDA cores' peak.
"""

from __future__ import annotations

from typing import NamedTuple

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

F32 = 4
I32 = 4


class Work(NamedTuple):
    flops: float
    bytes: float
    peak_flops: float

    def bound_s(self) -> float:
        """The least seconds the work could take on the card."""
        return max(self.flops / self.peak_flops,
                   self.bytes / HBM_BYTES_PER_S)


def product_flops(m: int, n: int, d: int, tier: str):
    """``(operations, peak)`` of an m x d by d x n float32 product at a
    precision tier."""
    base = 2.0 * m * n * d
    if tier == "high":
        return 3.0 * base, BF16_FLOPS
    if tier == "default":
        return base, BF16_FLOPS
    if tier == "highest":
        return base, F32_FLOPS
    raise ValueError(f"unknown tier {tier!r}")


def knn_topk(q: int, n: int, d: int, k: int, tier: str) -> Work:
    """Exact k-NN of q queries over n rows: the q x n distance product;
    queries and rows read once, k distances and ids a query written."""
    flops, peak = product_flops(q, n, d, tier)
    nbytes = (q + n) * d * F32 + q * k * (F32 + I32)
    return Work(flops, nbytes, peak)


def lloyd_pass(m: int, n_clusters: int, d: int, tier: str) -> Work:
    """One Lloyd pass: the m x n_clusters distance product for the
    argmin; rows and centroids read once; the new sums and counts and
    each row's label and distance written once."""
    flops, peak = product_flops(m, n_clusters, d, tier)
    nbytes = (m + n_clusters) * d * F32 + n_clusters * (d + 1) * F32 \
        + m * (F32 + I32)
    return Work(flops, nbytes, peak)


def ivf_search(q: int, n_lists: int, d: int, k: int, probed_rows: int,
               union_rows: int, tier: str) -> Work:
    """One IVF-Flat search call of q queries: the coarse q x n_lists
    product and each query's products with the real rows of its probed
    lists (``probed_rows`` summed over the queries); read once: the
    queries, the centroids and the union of the probed lists' real rows
    (``union_rows``) with their ids; written: k distances and ids a
    query. Padding slots count for nothing."""
    coarse, peak = product_flops(q, n_lists, d, tier)
    fine, _ = product_flops(1, probed_rows, d, tier)
    nbytes = (q + n_lists) * d * F32 + union_rows * (d * F32 + I32) \
        + q * k * (F32 + I32)
    return Work(coarse + fine, nbytes, peak)

