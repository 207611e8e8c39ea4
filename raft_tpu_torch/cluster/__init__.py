"""Clustering of the port: single-device k-means."""

from raft_tpu_torch.cluster.kmeans import (  # noqa: F401
    KMeansInit,
    KMeansParams,
    cluster_cost,
    kmeans_fit,
    kmeans_fit_predict,
    kmeans_predict,
    kmeans_transform,
    lloyd_iterate_prepared,
    lloyd_step,
    lloyd_step_prepared,
    weighted_lloyd_step,
)
