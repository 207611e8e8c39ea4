"""Drivers: how a cell calls the program. A workload file names its
driver (``drivers/<name>.py``), which defines ``Driver``, a subclass of
:class:`Base`.

A run is ``setup()`` (data, index, warm-up: the set-up time), then
``window(seconds, span)`` (the measured work, ending in a device
synchronise), then ``release()`` (the program's state freed), then
``check()`` (the reference's comparison). Drivers import the program;
the references they call do not.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from portbench import data


@dataclasses.dataclass
class Cell:
    """Everything a run knows of its cell, read from the files."""

    name: str
    config: dict           # configs/<config>.json
    traffic: dict          # traffic/<mix>.json
    workload: dict         # workloads/<cell>.json
    seed: int
    device: torch.device


@dataclasses.dataclass
class WindowResult:
    """What the window measured: ``attempted`` and ``failed`` units of
    work, the end-to-end values by metric name, and the counts the
    per-layer readers and the evidence lines read."""

    seconds: float
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    evidence: Dict[str, object] = dataclasses.field(default_factory=dict)


class Base:
    # fault name -> a function that plants it under the program and
    # returns the undo (``portbench.faults``)
    FAULTS: Dict[str, Callable[[], Callable[[], None]]] = {}

    def __init__(self, cell: Cell):
        self.cell = cell
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.device = cell.device
        self.rng = np.random.default_rng(data.derive_seed(cell.seed, 5))
        self.result: Optional[WindowResult] = None
        self.kept: list = []
        self._offered = 0
        self._keep_rng = np.random.default_rng(data.derive_seed(cell.seed, 6))

    # -- helpers --------------------------------------------------------

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def base_rows(self) -> torch.Tensor:
        return data.base(self.cfg["data"], int(self.cfg["n_base"]),
                         self.device)

    def query_set(self) -> torch.Tensor:
        return data.queries(self.cfg["data"], int(self.traffic["query_set"]),
                            self.cell.seed, self.device)

    def closed_loop(self, seconds: float, call) -> tuple:
        """Calls ``call(i)`` back to back, each ending in a synchronise,
        until ``seconds`` have passed; ``(calls, elapsed seconds)``."""
        t0 = time.monotonic()
        calls = 0
        while True:
            call(calls)
            self.sync()
            calls += 1
            if time.monotonic() - t0 >= seconds:
                break
        return calls, time.monotonic() - t0

    def keep(self, item, k: int) -> None:
        """Offer one output of the window to a sample of ``k`` drawn
        uniformly from the seed (reservoir sampling), so the window holds
        ``k`` outputs however many calls it makes."""
        self._offered += 1
        if len(self.kept) < k:
            self.kept.append(item)
            return
        j = int(self._keep_rng.integers(0, self._offered))
        if j < k:
            self.kept[j] = item

    # -- the run --------------------------------------------------------

    def setup(self) -> None:
        raise NotImplementedError

    def window(self, seconds: float, span) -> WindowResult:
        raise NotImplementedError

    def release(self) -> None:
        """Free the program's state before the reference runs."""

    def check(self) -> Dict[str, float]:
        raise NotImplementedError

    def layer_counts(self) -> Dict[str, float]:
        """Yardstick counts for the traced run's readers, worked out
        after the window (before :meth:`release`)."""
        return {}
