"""Background scrub and read repair of a streaming journal (counterpart
of ``raft_tpu/neighbors/scrub.py``).

The WAL and epoch containers carry a CRC32 an entry, which recovery
checks; the scrubber checks them on an interval instead, before a
restart needs them:

- every epoch snapshot and WAL record on disk is parsed end to end
  (every entry's CRC) each pass;
- a damaged file is quarantined (renamed to ``<name>.quarantined``, which
  no recovery walk reads), then repaired up a ladder: the index in
  memory writes a fresh epoch snapshot, else another intact epoch on
  disk already covers it, else a ``repair_source`` callable gives a
  healthy replica's epoch entries; when nothing holds,
  :class:`~raft_tpu_torch.neighbors.streaming.ShardCorruptError` is
  raised;
- the packed state in memory has a sidecar: each pass records
  ``(snapshot version, CRC over packed_db ‖ packed_ids ‖ tombstones)``.
  The same version with another CRC means the bytes changed with no
  mutation (on the card or the host); it is repaired from
  ``repair_source`` or raised. The packed tensors are read to the host
  for it, once a pass.

Metered through obs: ``scrub_passes_total``,
``scrub_corruptions_total{outcome=repaired|quarantined}``,
``scrub_memory_repairs_total``. ``FaultInjector.corrupt_bytes`` makes the
damage the tests repair.
"""

from __future__ import annotations

import os
import threading
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import env, trace
from raft_tpu_torch.core.checkpoint import CheckpointError, restore_checkpoint
from raft_tpu_torch.neighbors.streaming import (MutationLog, ShardCorruptError,
                                                StreamingError, StreamingIndex,
                                                _WAL_RE, _raw_bytes)

__all__ = ["Scrubber", "ScrubReport"]


@dataclass
class ScrubReport:
    """What one scrub pass found and did."""

    files_checked: int = 0
    corrupt: List[str] = field(default_factory=list)
    repaired: List[str] = field(default_factory=list)
    quarantined: List[str] = field(default_factory=list)
    memory_repaired: bool = False


class Scrubber:
    """Interval scrub of one streaming journal and, given an ``index``,
    of its packed state in memory.

    ``index`` gives the whole ladder (the rewrite from memory and the
    sidecar); ``log`` alone scrubs a cold directory (a dead replica's
    journal). ``repair_source`` is a zero-argument callable returning a
    healthy replica's epoch entries. ``interval`` defaults to
    ``RAFT_TPU_SCRUB_INTERVAL``. The worker thread reads the packed state
    on the default stream (a new thread's current stream); a failure it
    dies on is raised again by :meth:`stop`."""

    def __init__(self, index: Optional[StreamingIndex] = None, *,
                 log: Optional[MutationLog] = None,
                 interval: Optional[float] = None,
                 repair_source: Optional[Callable[[], Dict]] = None):
        if index is not None:
            if log is not None and log is not index.log:
                raise ValueError("pass index= OR log=, not both")
            log = index.log
        if log is None:
            raise ValueError(
                "scrubbing needs a journal: a journaled index= or an "
                "explicit log=")
        self.index = index
        self.log = log
        self.repair_source = repair_source
        self.interval = float(env.read("RAFT_TPU_SCRUB_INTERVAL")
                              if interval is None else interval)
        if self.interval <= 0:
            raise ValueError(f"interval must be > 0, got {self.interval}")
        self.passes = 0
        self.corruptions = 0
        self._sidecar: Optional[Tuple[int, int]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- one pass ------------------------------------------------------

    def _walk(self) -> List[str]:
        """Every journal container on disk: the epoch snapshots, then the
        WAL records, ascending."""
        paths = [self.log.epoch_path(s) for s in self.log.epoch_steps()]
        paths += [os.path.join(self.log.directory, f)
                  for f in sorted(os.listdir(self.log.directory))
                  if _WAL_RE.match(f)]
        return paths

    def run_once(self) -> ScrubReport:
        """One whole pass; returns its report. Raises
        :class:`ShardCorruptError` for damage nothing on the ladder
        repairs (the file stays quarantined)."""
        self.passes += 1
        if obs.enabled():
            obs.inc("scrub_passes_total")
        report = ScrubReport()
        for path in self._walk():
            report.files_checked += 1
            try:
                restore_checkpoint(path)
            except FileNotFoundError:
                continue  # pruned between the walk and the check
            except CheckpointError as exc:
                self._handle_corrupt(path, str(exc), report)
        self._check_memory(report)
        trace.record_event("scrub.pass", files=report.files_checked,
                           corrupt=len(report.corrupt),
                           repaired=len(report.repaired))
        return report

    def _handle_corrupt(self, path: str, detail: str,
                        report: ScrubReport) -> None:
        name = os.path.basename(path)
        self.corruptions += 1
        report.corrupt.append(name)
        # quarantine first: the suffix stops every journal pattern from
        # matching, so no recovery reads the damage
        os.replace(path, path + ".quarantined")
        report.quarantined.append(name)
        trace.record_event("scrub.quarantine", file=name, error=detail)
        repaired = False
        if self.index is not None:
            # the state in memory is the authority while the process
            # lives: rewrite the current epoch (it folds the WAL too)
            with self.index._lock:
                self.index._write_epoch_locked(crash=False)
            repaired = True
        elif self._intact_epoch_exists():
            repaired = True
        elif self.repair_source is not None:
            # a cold directory: land a healthy peer's entries as a fresh
            # snapshot for the next recover()
            steps = self.log.epoch_steps()
            self.log.write_epoch((max(steps) + 1) if steps else 0,
                                 dict(self.repair_source()))
            repaired = True
        if obs.enabled():
            obs.inc("scrub_corruptions_total",
                    outcome="repaired" if repaired else "quarantined")
        if repaired:
            report.repaired.append(name)
        else:
            raise ShardCorruptError(
                name, f"{detail} — no healthy index, repair source, or "
                      "intact epoch to repair from")

    def _intact_epoch_exists(self) -> bool:
        for step in reversed(self.log.epoch_steps()):
            try:
                restore_checkpoint(self.log.epoch_path(step))
                return True
            except (CheckpointError, FileNotFoundError):
                continue
        return False

    def _check_memory(self, report: ScrubReport) -> None:
        """Sidecar check of the packed state: the same snapshot version
        with other bytes is damage (every publish bumps the version)."""
        if self.index is None:
            return
        with self.index._lock:
            snap = self.index.snapshot
            crc = zlib.crc32(_raw_bytes(snap.flat.packed_db))
            crc = zlib.crc32(_raw_bytes(
                snap.flat.packed_ids.to(torch.int32)), crc)
            crc = zlib.crc32(self.index._tomb_host.tobytes(), crc)
            version = snap.version
        if self._sidecar is not None and self._sidecar[0] == version \
                and self._sidecar[1] != crc:
            self.corruptions += 1
            trace.record_event("scrub.memory_corrupt", version=version)
            if self.repair_source is None:
                if obs.enabled():
                    obs.inc("scrub_corruptions_total",
                            outcome="quarantined")
                raise ShardCorruptError(
                    "memory", f"packed state changed under version "
                              f"{version} with no mutation — RAM "
                              "damage and no repair source")
            self.index.install_snapshot(self.repair_source())
            report.memory_repaired = True
            if obs.enabled():
                obs.inc("scrub_corruptions_total", outcome="repaired")
                obs.inc("scrub_memory_repairs_total")
            # the next pass takes the installed state as its baseline
            self._sidecar = None
            return
        self._sidecar = (version, crc)

    # -- worker thread -------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.run_once()
            except Exception as exc:  # noqa: BLE001 — raised at stop
                self._error = exc
                obs.record_failure(exc)
                trace.record_event("scrub.worker_error", error=str(exc))
                return

    def start(self) -> "Scrubber":
        if self._thread is not None:
            raise StreamingError("scrubber already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="raft-tpu-scrubber")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the worker and raise any failure it died on."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise StreamingError("background scrubber failed") from err

    def __enter__(self) -> "Scrubber":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
