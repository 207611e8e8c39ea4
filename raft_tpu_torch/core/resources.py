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
           "default_resources", "resolve_device", "as_tensor", "get_mesh",
           "set_mesh", "get_comms", "set_comms", "comms_initialized"]

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
    """Device, generator state, stream, mesh and communicator for one
    device. ``other`` copies another handle's resources (the reference's
    copy constructor); ``mesh`` is a ``DeviceMesh`` for multi-rank work
    (:func:`get_mesh`)."""

    def __init__(self, device: Union[str, torch.device, None] = None,
                 mesh=None, seed: int = 0,
                 other: Optional["DeviceResources"] = None):
        if other is not None:
            self.device, self.rng_state = other.device, other.rng_state
            self.mesh, self.comms = other.mesh, other.comms
            return
        self.device = resolve_device(device)
        self.rng_state = RngState(seed=seed)
        self.mesh = mesh
        self.comms = None

    @property
    def stream(self) -> Optional["torch.cuda.Stream"]:
        """The stream kernels launch on (PyTorch's current stream of the
        device); ``None`` on the CPU."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.current_stream(self.device)

    def generator(self) -> torch.Generator:
        """A fresh generator on this device from the handle's state."""
        return self.rng_state.next_key(self.device)

    def get_comms(self):
        return get_comms(self)

    def sync_stream(self, *arrays) -> None:
        """Wait for the work queued on the handle's device (nothing on
        the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __repr__(self):
        return f"DeviceResources(device={self.device}, {self.rng_state})"


def device_resources(device: Union[str, torch.device, None] = None,
                     mesh=None, seed: int = 0) -> DeviceResources:
    """Create a handle; ``device=None`` is ``cuda:0``."""
    return DeviceResources(device=device, mesh=mesh, seed=seed)


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


def as_tensor(x, res: Optional[DeviceResources] = None) -> torch.Tensor:
    """The input rule of every entry point: a tensor stays on its device;
    anything else (a numpy array, a list) goes to the handle's device,
    ``cuda:0`` by default, which raises :class:`DeviceUnavailableError`
    without CUDA."""
    if isinstance(x, torch.Tensor):
        return x
    import numpy as np

    return torch.as_tensor(np.asarray(x), device=default_resources(res).device)


def get_mesh(res: DeviceResources):
    """Device mesh for multi-rank execution: the one set with
    :func:`set_mesh`, else (made once) a 1-D mesh named ``"data"`` over
    every rank of the default process group, on the handle's device
    type. With no process group up, a world of size 1 is started first
    (:func:`raft_tpu_torch.comms.bootstrap.initialize_distributed`:
    NCCL for a CUDA handle, gloo for a CPU one)."""
    if res.mesh is None:
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        from raft_tpu_torch.comms import bootstrap

        if not dist.is_initialized():
            bootstrap.initialize_distributed(
                num_processes=1, process_id=0,
                backend="nccl" if res.device.type == "cuda" else "gloo")
        bootstrap.check_backend(res.device.type)
        if res.device.type == "cuda":
            torch.cuda.set_device(res.device)
        res.mesh = init_device_mesh(res.device.type,
                                    (dist.get_world_size(),),
                                    mesh_dim_names=("data",))
    return res.mesh


def set_mesh(res: DeviceResources, mesh) -> None:
    res.mesh = mesh


def get_comms(res: DeviceResources):
    """Communicator injected into the handle. Raises if none was set,
    as the reference's: algorithms require ``build_mesh_comms`` (or a
    bootstrap injection) to have run first."""
    if res.comms is None:
        raise RuntimeError(
            "no communicator set on this handle; call "
            "raft_tpu_torch.comms.build_mesh_comms(res, mesh) first")
    return res.comms


def set_comms(res: DeviceResources, comms) -> None:
    res.comms = comms


def comms_initialized(res: DeviceResources) -> bool:
    return res.comms is not None
