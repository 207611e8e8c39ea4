"""The quantizer's fit: a closed loop of ``cluster.kmeans.kmeans_fit``
calls on the whole database with the configuration's ``n_clusters``,
``max_iter`` and ``init`` (``KMeansInit``'s value), the default
tolerance and the run's seed."""

from __future__ import annotations

import torch

from portbench import compare, faults, roofline
from portbench.drivers import Base, WindowResult
from portbench.reference import kmeans as ref_kmeans
from portbench.reference.knn import direct_sq_l2


class Driver(Base):
    FAULTS = {name: (lambda name=name: faults.plant_kmeans(name))
              for name in ("unchanged", "half", "altered")}

    def setup(self) -> None:
        from raft_tpu_torch.cluster.kmeans import (KMeansInit, KMeansParams,
                                                   kmeans_fit)

        self.kmeans_fit = kmeans_fit
        self.params = KMeansParams(
            n_clusters=int(self.cfg["n_clusters"]),
            max_iter=int(self.cfg["max_iter"]), seed=int(self.cell.seed),
            init=KMeansInit(self.cfg["init"]))
        self.x = self.base_rows()
        self.n_iters = []
        self._call()
        self.n_iters.clear()
        self.kept.clear()
        self._offered = 0

    def _call(self) -> None:
        c, inertia, labels, n_iter = self.kmeans_fit(None, self.params,
                                                     self.x)
        self.n_iters.append(int(n_iter))
        self.keep((c, inertia, labels, int(n_iter)), 1)

    def window(self, seconds: float, span) -> WindowResult:
        def call(_):
            with span("kmeans_fit"):
                self._call()

        calls, elapsed = self.closed_loop(seconds, call)
        return WindowResult(elapsed, calls, 0,
                            {"fit_ms": 1e3 * elapsed / calls},
                            counts={"fits": calls,
                                    "lloyd_iters": sum(self.n_iters)},
                            evidence={"n_iter_per_fit": sorted(
                                set(self.n_iters))})

    def layer_counts(self):
        m, d = self.x.shape
        work = roofline.lloyd_pass(m, int(self.cfg["n_clusters"]), d,
                                   self.cfg["precision"])
        return {"lloyd_bound_s": work.bound_s() * sum(self.n_iters)}

    def check(self):
        """One fit of the window, drawn from the seed (by reservoir): its
        centroids and labels against the reference's own fit (k-means++
        and the same number of Lloyd iterations,
        :func:`compare.quantizer_numbers`), and ``n_iter_out``, 1 when
        ``n_iter`` is outside 1..max_iter. The returned inertia against
        the returned labels' true cost (relatively) is reported beside,
        as evidence: no fault and not the control separate it from
        sound runs."""
        c, inertia, labels, n_iter = self.kept[0]
        c = c.to(torch.float32)
        x = self.x
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.cell.seed & ((1 << 63) - 1))
        ref_c = ref_kmeans.fit(x, c.shape[0], int(self.cfg["max_iter"]), gen)
        numbers = compare.quantizer_numbers(x, c, labels, ref_c)
        lab = labels.long().clamp(0, c.shape[0] - 1)
        true_cost = float(direct_sq_l2(x, c, lab[:, None])
                          .to(torch.float64).sum())
        self.result.evidence["inertia_gap"] = abs(
            float(inertia) - true_cost) / true_cost
        numbers["n_iter_out"] = float(
            not 1 <= n_iter <= int(self.cfg["max_iter"]))
        return numbers
