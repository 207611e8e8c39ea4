"""IVF-Flat search in batch: set-up builds the index with
``neighbors.ivf_flat.build`` (its own ``kmeans_fit``), then a closed
loop of one caller sends ``ivf_flat.search`` calls of ``rows_per_call``
queries at the configuration's ``nprobe``."""

from __future__ import annotations

import numpy as np
import torch

from portbench import compare, faults, roofline
from portbench.drivers import WindowResult
from portbench.drivers.knn_batch import Driver as KnnBatch
from portbench.reference import kmeans as ref_kmeans
from portbench.reference.ivf import firm_topk, probed_lists


def _search_fault(name):
    return lambda: faults.plant_search(name, "ivf")


def _build_fault(name):
    return lambda: faults.plant_kmeans(name)


class Driver(KnnBatch):
    # the search's faults, and the quantizer's under the index's build
    FAULTS = {"altered": _search_fault("altered"),
              "half": _search_fault("half"),
              "build_unchanged": _build_fault("unchanged"),
              "build_half": _build_fault("half")}

    def setup(self) -> None:
        from raft_tpu_torch.neighbors import ivf_flat

        self.ivf_flat = ivf_flat
        self.nprobe = int(self.cfg["nprobe"])
        self.index = ivf_flat.build(None, self.base_rows(),
                                    int(self.cfg["n_lists"]),
                                    max_iter=int(self.cfg["max_iter"]))
        self._queries_and_warm()

    def _call(self, i: int) -> None:
        b = i % len(self.rows)
        q = self.queries[self.rows[b]]
        d, ids = self.ivf_flat.search(None, self.index, q, self.k,
                                      self.nprobe)
        self.calls.append(b)
        self.keep((b, d, ids), int(self.cell.workload["check_calls"]))

    def window(self, seconds: float, span) -> WindowResult:
        def call(i):
            with span("ivf_flat.search"):
                self._call(i)

        calls, elapsed = self.closed_loop(seconds, call)
        rows = calls * int(self.traffic["rows_per_call"])
        sizes = self.index.sizes.cpu().numpy()
        index_bytes = sum(t.numel() * t.element_size() for t in (
            self.index.centroids, self.index.packed_db,
            self.index.packed_ids, self.index.starts, self.index.sizes))
        return WindowResult(
            elapsed, calls, 0, {"qps": rows / elapsed},
            counts={"calls": calls, "rows": rows},
            evidence={"list_rows_min_median_max": [
                int(sizes.min()), float(np.median(sizes)),
                int(sizes.max())],
                "cap_max": int(self.index.cap_max),
                "index_device_bytes": int(index_bytes)})

    def layer_counts(self):
        """The bound of every call of the window, summed: the probed
        lists worked out from the index's centroids and sizes."""
        c = self.index.centroids.to(torch.float32)
        sizes = self.index.sizes.to(torch.int64)
        n_lists, d = c.shape
        bound = 0.0
        per_block = {}
        for b in self.calls:
            if b not in per_block:
                probed = probed_lists(self.queries[self.rows[b]], c,
                                      self.nprobe)
                union = torch.unique(probed)
                work = roofline.ivf_search(
                    probed.shape[0], n_lists, d, self.k,
                    int(sizes[probed].sum()), int(sizes[union].sum()),
                    self.cfg["precision"])
                per_block[b] = work.bound_s()
            bound += per_block[b]
        return {"ivf_search_bound_s": bound}

    def release(self) -> None:
        # the index's centroids and the list of each row, as packed, are
        # outputs of the build, judged in check(); the rows are made again
        index = self.index
        self.centroids = index.centroids.to(torch.float32).clone()
        self.lists, self.packed_rows_off = packed_lists(index)
        self.index = index = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.db = self.base_rows()

    def check(self):
        """``check_calls`` calls of the window, drawn from the seed,
        against the firm candidates (``reference.ivf``), and the index
        the window searched: its centroids and each row's list against
        the reference's own fit of ``n_lists`` clusters
        (:func:`compare.quantizer_numbers`), and ``packed_rows_off``,
        the rows not packed exactly once."""
        got = self.kept
        rows = torch.cat([self.rows[b] for b, _, _ in got])
        q = self.queries[rows]
        tie = float(self.cell.workload["compare"]["tie"]) * float(
            torch.median((self.db * self.db).sum(1)))
        ref_d, _ = firm_topk(self.db, q, self.centroids, self.k,
                             self.nprobe, tie)
        numbers = compare.knn_numbers(self.db, q,
                                      torch.cat([d for _, d, _ in got]),
                                      torch.cat([i for _, _, i in got]),
                                      ref_d)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.cell.seed & ((1 << 63) - 1))
        ref_c = ref_kmeans.fit(self.db, int(self.cfg["n_lists"]),
                               int(self.cfg["max_iter"]), gen)
        numbers.update(compare.quantizer_numbers(self.db, self.centroids,
                                                 self.lists, ref_c))
        numbers["packed_rows_off"] = float(self.packed_rows_off)
        return numbers


def packed_lists(index):
    """``(list of each row [n_db], rows not packed exactly once)`` read
    from the index's packing: list ``l`` holds the slots from
    ``starts[l]``, its first ``sizes[l]`` live. A live slot past its
    list's size, or an id out of range, also counts as off; a row with
    no slot has the list -1."""
    ids = index.packed_ids.long()
    n = int(index.n_db)
    starts = index.starts.long()
    slot = torch.arange(ids.numel(), device=ids.device)
    lst = torch.searchsorted(starts, slot, right=True) - 1
    live = ids >= 0
    ok = live & (ids < n)
    past = live & ((slot - starts[lst.clamp_min(0)])
                   >= index.sizes.long()[lst.clamp_min(0)])
    times = torch.bincount(ids[ok], minlength=n)
    lists = torch.full((n,), -1, dtype=torch.long, device=ids.device)
    lists[ids[ok]] = lst[ok]
    off = int((times != 1).sum()) + int(past.sum()) + int((live & ~ok).sum())
    return lists, off
