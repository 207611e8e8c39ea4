"""Host-side memory observability (counterpart of
``raft_tpu/core/memory.py``).

PyTorch's caching allocator owns device memory, so the reference's
pluggable memory resources become observability and policy here:

- :class:`StatisticsTracker`: byte and allocation counters;
- :class:`NotifyingTracker`: allocation and deallocation event hooks;
- :class:`ResourceMonitor`: a background sampler writing CSV rows tagged
  with the current trace range;
- :func:`mmap_buffer`: tmpfile-backed mmap host memory for out-of-core
  staging;
- :func:`device_memory_stats`: live and peak device memory from the
  caching allocator's counters.
"""

from __future__ import annotations

import contextlib
import csv
import mmap
import os
import tempfile
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import trace


class StatisticsTracker:
    """Counts allocations and bytes reported through it."""

    def __init__(self):
        self._lock = threading.Lock()
        self.bytes_allocated = 0
        self.peak_bytes = 0
        self.allocation_count = 0
        self.deallocation_count = 0

    def on_alloc(self, nbytes: int) -> None:
        with self._lock:
            self.bytes_allocated += nbytes
            self.peak_bytes = max(self.peak_bytes, self.bytes_allocated)
            self.allocation_count += 1

    def on_dealloc(self, nbytes: int) -> None:
        with self._lock:
            self.bytes_allocated -= nbytes
            self.deallocation_count += 1

    def snapshot(self) -> Tuple[int, int, int, int]:
        with self._lock:
            return (self.bytes_allocated, self.peak_bytes,
                    self.allocation_count, self.deallocation_count)


class NotifyingTracker(StatisticsTracker):
    """Statistics tracker that also calls observers on every event."""

    def __init__(self):
        super().__init__()
        self._observers: List[Callable[[str, int], None]] = []

    def subscribe(self, fn: Callable[[str, int], None]) -> None:
        self._observers.append(fn)

    def on_alloc(self, nbytes: int) -> None:
        super().on_alloc(nbytes)
        for fn in self._observers:
            fn("alloc", nbytes)

    def on_dealloc(self, nbytes: int) -> None:
        super().on_dealloc(nbytes)
        for fn in self._observers:
            fn("dealloc", nbytes)


def device_memory_stats(device=None) -> dict:
    """Device memory in bytes under the reference's keys:
    ``bytes_in_use`` (``torch.cuda.memory_allocated``),
    ``peak_bytes_in_use`` (``torch.cuda.max_memory_allocated``) and
    ``bytes_limit`` (the card's total memory). ``device`` defaults to
    ``cuda:0``, which raises without CUDA; the CPU has no such counters
    and reports zeros."""
    from raft_tpu_torch.core.resources import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    return {
        "bytes_in_use": int(torch.cuda.memory_allocated(dev)),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev)),
        "bytes_limit": int(torch.cuda.get_device_properties(dev)
                           .total_memory),
    }


class ResourceMonitor:
    """Background thread sampling memory statistics to CSV, each row
    tagged with the starting thread's active trace range. ``device``
    (``cuda:0`` by default) is resolved when the monitor starts."""

    def __init__(self, path: str, tracker: Optional[StatisticsTracker] = None,
                 interval_s: float = 0.1, device=None):
        self.path = path
        self.tracker = tracker
        self.interval_s = interval_s
        self.device = device
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._file = None
        self._range_fn = trace.current_range

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError(
                "ResourceMonitor already started; stop() it first")
        from raft_tpu_torch.core.resources import resolve_device

        dev = resolve_device(self.device)
        # the file lives on self so that stop(), not the sampler thread,
        # flushes and closes it
        self._file = open(self.path, "w", newline="")
        writer = csv.writer(self._file)
        writer.writerow(["time_s", "range", "host_bytes", "host_peak",
                         "device_bytes", "device_peak"])
        t0 = time.monotonic()

        def run():
            while not self._stop.is_set():
                host_bytes = host_peak = 0
                if self.tracker is not None:
                    host_bytes, host_peak, _, _ = self.tracker.snapshot()
                dstats = device_memory_stats(dev)
                writer.writerow([
                    f"{time.monotonic() - t0:.4f}",
                    self._range_fn() or "",
                    host_bytes, host_peak,
                    dstats["bytes_in_use"], dstats["peak_bytes_in_use"],
                ])
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Join the sampler thread, then flush and close the CSV file.
        Idempotent; a stopped monitor can start again (truncating the
        file)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._file is not None:
            self._file.flush()
            self._file.close()
            self._file = None
        self._stop.clear()


class MmapBuffer:
    """tmpfile-backed mmap host buffer for out-of-core staging."""

    def __init__(self, nbytes: int, dir: Optional[str] = None):
        # mkstemp, then unlink at once: the backing file has no name from
        # the first moment, so none can leak if the process dies
        fd, path = tempfile.mkstemp(dir=dir, prefix="raft_tpu_mmap_")
        try:
            os.unlink(path)
        except OSError:
            os.close(fd)
            raise
        self._file = os.fdopen(fd, "r+b")
        self._file.truncate(nbytes)
        self.nbytes = nbytes
        self._closed = False
        self._mmap = mmap.mmap(self._file.fileno(), nbytes)

    def as_array(self, dtype=np.uint8, shape=None) -> np.ndarray:
        arr = np.frombuffer(self._mmap, dtype=dtype)
        return arr.reshape(shape) if shape is not None else arr

    def close(self) -> None:
        """Release the mapping and the descriptor. Idempotent; the
        descriptor closes even while array views keep the mapping
        alive."""
        if self._closed:
            return
        self._closed = True
        try:
            with contextlib.suppress(BufferError):
                self._mmap.close()
        finally:
            self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def mmap_buffer(nbytes: int, dir: Optional[str] = None) -> MmapBuffer:
    return MmapBuffer(nbytes, dir=dir)
