"""Exact k-NN in batch: ``neighbors.knn`` over the whole database, a
closed loop of one caller sending calls of ``rows_per_call`` queries
(ann-benchmarks' batch mode)."""

from __future__ import annotations

import math

import torch

from portbench import compare, faults, roofline, traffic
from portbench.drivers import Base, WindowResult
from portbench.reference.knn import exact_topk


class Driver(Base):
    FAULTS = {name: (lambda name=name: faults.plant_search(name, "knn"))
              for name in ("altered", "half")}

    def setup(self) -> None:
        from raft_tpu_torch.neighbors import knn

        self.knn = knn
        self.db = self.base_rows()
        self._queries_and_warm()

    def _queries_and_warm(self) -> None:
        """The run's query blocks, then two calls (the shapes the window
        uses; the first run in a checkout builds the kernels here)."""
        self.k = int(self.cfg["k"])
        self.queries = self.query_set()
        self.rows = [torch.as_tensor(traffic.closed_rows(self.traffic, i),
                                     device=self.device)
                     for i in range(self._n_blocks())]
        self.calls = []
        for i in range(2):
            self._call(i)
            self.sync()
        self.kept.clear()
        self._offered = 0
        self.calls = []

    def _n_blocks(self) -> int:
        """Distinct blocks before the walk over the set repeats."""
        n = int(self.traffic["query_set"])
        return n // math.gcd(n, int(self.traffic["rows_per_call"]))

    def _call(self, i: int) -> None:
        b = i % len(self.rows)
        q = self.queries[self.rows[b]]
        d, ids = self.knn(None, self.db, q, k=self.k)
        self.calls.append(b)
        self.keep((b, d, ids), int(self.cell.workload["check_calls"]))

    def window(self, seconds: float, span) -> WindowResult:
        def call(i):
            with span("knn"):
                self._call(i)

        calls, elapsed = self.closed_loop(seconds, call)
        rows = calls * int(self.traffic["rows_per_call"])
        return WindowResult(elapsed, calls, 0, {"qps": rows / elapsed},
                            counts={"calls": calls, "rows": rows})

    def layer_counts(self):
        n, d = self.db.shape
        work = roofline.knn_topk(int(self.traffic["rows_per_call"]), n, d,
                                 self.k, self.cfg["precision"])
        return {"fused_topk_bound_s_per_call": work.bound_s()}

    def check(self):
        """``check_calls`` calls of the window, drawn from the seed."""
        got = self.kept
        rows = torch.cat([self.rows[b] for b, _, _ in got])
        q = self.queries[rows]
        ref_d, _ = exact_topk(self.db, q, self.k)
        return compare.knn_numbers(self.db, q,
                                   torch.cat([d for _, d, _ in got]),
                                   torch.cat([i for _, _, i in got]), ref_d)
