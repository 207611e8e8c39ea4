"""Memory-type vocabulary (counterpart of ``raft_tpu/core/memory_type.py``).

``HOST`` is pageable host memory (a CPU tensor), ``PINNED`` page-locked
host memory (``pin_memory=True`` wherever the process has CUDA),
``DEVICE`` the card's memory. ``MANAGED`` is both device- and
host-accessible, as in the reference package; its buffers are device
tensors here, as the reference's are device arrays.
"""

from __future__ import annotations

import enum


class MemoryType(enum.Enum):
    HOST = "host"
    PINNED = "pinned"
    DEVICE = "device"
    MANAGED = "managed"

    @property
    def is_device_accessible(self) -> bool:
        return self in (MemoryType.DEVICE, MemoryType.MANAGED)

    @property
    def is_host_accessible(self) -> bool:
        return self in (MemoryType.HOST, MemoryType.PINNED, MemoryType.MANAGED)


HOST = MemoryType.HOST
PINNED = MemoryType.PINNED
DEVICE = MemoryType.DEVICE
MANAGED = MemoryType.MANAGED
