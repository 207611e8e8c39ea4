"""raft_tpu_torch.serve — shape-bucketed dynamic batching with
multi-tenant QoS, quality brownout, replica fleets with hedged dispatch,
the load generator with its chaos scenarios, and streaming ingest
behind the executor (counterpart of ``raft_tpu/serve``).

The serving runtime coalesces many small per-user query blocks into the
large padded batches the card is fast at, while keeping the per-request
contract: each request gets the bits of its own eager call, typed errors
(``RejectedError`` backpressure, ``DeadlineExceededError`` expiry), and
weighted-fair scheduling across tenants.

Quickstart::

    from raft_tpu_torch import serve

    ex = serve.Executor(
        [serve.KnnService(db, k=10)],
        policy=serve.BatchPolicy(max_batch=256, max_wait_ms=5.0),
        qos=serve.QosPolicy({"gold": serve.TenantPolicy(
            weight=4.0, slo_latency_s=0.05)}),   # 99% under 50 ms
    )
    ex.warm()                       # zero compiles after this
    with ex:                        # start/stop the drain thread
        fut = ex.submit("knn_k10_l2", queries, tenant="gold",
                        deadline_s=0.1)
        dist, idx = fut.result(timeout=1.0)
"""

from raft_tpu_torch.serve.brownout import (BrownoutController,
                                           BrownoutFloorError,
                                           DegradationLadder, ivf_ladder,
                                           knn_ladder)
from raft_tpu_torch.serve.executor import (Executor, ExecutorStats,
                                           IvfKnnService, IvfMnmgKnnService,
                                           IvfPqKnnService, KMeansPredictService,
                                           KnnService, PairwiseService,
                                           Service)
from raft_tpu_torch.serve.ingest import (IngestController, NotLeaderError,
                                         StreamingKnnService)
from raft_tpu_torch.serve.loadgen import (CatchupLoadReport, ChaosReport,
                                          FleetReport, LoadReport,
                                          StreamingReport,
                                          catchup_under_load, closed_loop,
                                          fleet_closed_loop, open_loop,
                                          run_chaos, streaming_loop)
from raft_tpu_torch.serve.qos import QosPolicy, TenantPolicy
from raft_tpu_torch.serve.queue import (BUCKET_FLOOR, Batch, BatchPolicy,
                                        Request, RequestQueue, ResultFuture,
                                        bucket_ladder, bucket_rows)
from raft_tpu_torch.serve.replica import (HedgePolicy, RecoveryReport,
                                          Replica, ReplicaGroup,
                                          ReplicaGroupStats)

__all__ = [
    "BUCKET_FLOOR", "bucket_rows", "bucket_ladder",
    "Request", "ResultFuture", "Batch", "BatchPolicy", "RequestQueue",
    "TenantPolicy", "QosPolicy",
    "Service", "KnnService", "IvfKnnService", "IvfPqKnnService",
    "IvfMnmgKnnService", "PairwiseService", "KMeansPredictService",
    "Executor", "ExecutorStats",
    "Replica", "ReplicaGroup", "ReplicaGroupStats", "RecoveryReport",
    "HedgePolicy",
    "BrownoutController", "BrownoutFloorError", "DegradationLadder",
    "ivf_ladder", "knn_ladder",
    "StreamingKnnService", "IngestController",
    "LoadReport", "FleetReport", "ChaosReport", "StreamingReport",
    "CatchupLoadReport",
    "closed_loop", "open_loop", "fleet_closed_loop", "streaming_loop",
    "catchup_under_load", "run_chaos",
]
