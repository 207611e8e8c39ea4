"""Statistics and metrics of the port (counterpart of ``raft_tpu/stats``):
moments, histograms, information criteria, the external clustering
scores from one contingency table in closed form, the silhouette (the
unexpanded tile's distances, ``csr_spmm``'s keyed sums) and
trustworthiness (the unexpanded tile, the insertion top-k)."""

from raft_tpu_torch.stats.moments import (  # noqa: F401
    mean,
    stddev,
    vars_,
    sum_,
    meanvar,
    mean_center,
    mean_add,
    minmax,
    cov,
    weighted_mean,
    row_weighted_mean,
    col_weighted_mean,
)
from raft_tpu_torch.stats.histogram import HistType, histogram  # noqa: F401
from raft_tpu_torch.stats.information import (  # noqa: F401
    entropy,
    kl_divergence,
    IC_Type,
    information_criterion,
    information_criterion_batched,
    cluster_dispersion,
)
from raft_tpu_torch.stats.clustering_metrics import (  # noqa: F401
    contingency_matrix,
    rand_index,
    adjusted_rand_index,
    mutual_info_score,
    homogeneity_score,
    completeness_score,
    v_measure,
    silhouette_score,
)
from raft_tpu_torch.stats.regression_metrics import (  # noqa: F401
    accuracy,
    r2_score,
    regression_metrics,
)
from raft_tpu_torch.stats.neighborhood import (  # noqa: F401
    neighborhood_recall,
    trustworthiness_score,
)
