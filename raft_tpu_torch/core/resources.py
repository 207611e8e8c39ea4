"""The handle of the port: the device, a seeded generator and a stream.

Counterpart of ``raft_tpu/core/resources.py``. Where the reference
package's handle holds a ``jax.Device`` and a mesh, this one holds a
``torch.device``, an :class:`~raft_tpu_torch.random.rng_state.RngState`
(explicit ``torch.Generator``s, never the global RNG) and, on CUDA, the
stream kernels launch on.

Entry points run on the card: with no argument the handle is ``cuda:0``,
and without CUDA that raises :class:`DeviceUnavailableError` instead of
falling back to the CPU. A CPU handle exists only when asked for by name
(``device="cpu"``), which is what the CPU tests do.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Union

import torch

from raft_tpu_torch.random.rng_state import RngState

__all__ = ["DeviceResources", "DeviceUnavailableError", "device_resources",
           "default_resources", "resolve_device"]

DEFAULT_DEVICE = "cuda:0"


class DeviceUnavailableError(RuntimeError):
    """The requested CUDA device does not exist in this process."""


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """``None`` means ``cuda:0``. A CUDA device that is not present
    raises :class:`DeviceUnavailableError`; there is no CPU fallback."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                f"device {dev} requested but CUDA is not available; pass "
                "device='cpu' to run the plain versions on the host")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise DeviceUnavailableError(
                f"device {dev} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
        dev = torch.device("cuda", index)
    elif dev.type != "cpu":
        raise DeviceUnavailableError(f"unsupported device type {dev.type!r}")
    return dev


class DeviceResources:
    """Device, generator state and stream for one device."""

    def __init__(self, device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        self.device = resolve_device(device)
        self.rng_state = RngState(seed=seed)

    @property
    def stream(self) -> Optional["torch.cuda.Stream"]:
        """The stream kernels launch on (PyTorch's current stream of the
        device); ``None`` on the CPU."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.current_stream(self.device)

    def generator(self) -> torch.Generator:
        """A fresh generator on this device from the handle's state."""
        return self.rng_state.next_generator(self.device)

    def __repr__(self):
        return f"DeviceResources(device={self.device}, {self.rng_state})"


def device_resources(device: Union[str, torch.device, None] = None,
                     seed: int = 0) -> DeviceResources:
    """Create a handle; ``device=None`` is ``cuda:0``."""
    return DeviceResources(device=device, seed=seed)


_lock = threading.Lock()
_handles: Dict[torch.device, DeviceResources] = {}


def default_resources(res: Optional[DeviceResources] = None
                      ) -> DeviceResources:
    """``res``, or the process-wide handle for ``cuda:0``."""
    if res is not None:
        return res
    dev = resolve_device(None)
    with _lock:
        if dev not in _handles:
            _handles[dev] = DeviceResources(dev)
        return _handles[dev]
