"""The handle of the port: a lazily built, type-indexed resource registry
(counterpart of ``raft_tpu/core/resources.py``).

Where the reference package's handle holds a ``jax.Device`` and a mesh,
this one holds a ``torch.device``, an
:class:`~raft_tpu_torch.random.rng_state.RngState` (explicit
``torch.Generator``s, never the global RNG), a ``DeviceMesh``, a
communicator and the host-side services (cancel token, workspace limit,
memory statistics). Resources are registered as factories and built on
first access, under a lock (:class:`Resources`); the accessors below
register a default factory on demand, as the reference's do.

Entry points run on the card: with no argument the handle is ``cuda:0``,
and without CUDA that raises :class:`DeviceUnavailableError` instead of
falling back to the CPU. A CPU handle exists only when asked for by name
(``device="cpu"``), which is what the CPU tests do.
"""

from __future__ import annotations

import enum
import threading
from typing import Any, Callable, Dict, Optional, Union

import torch

from raft_tpu_torch.random.rng_state import RngState

__all__ = ["ResourceType", "ResourceFactory", "Resources", "DeviceResources",
           "Handle", "DeviceUnavailableError", "device_resources",
           "get_device_resources", "default_resources", "resolve_device",
           "as_tensor", "get_device", "set_device", "get_mesh", "set_mesh",
           "get_rng_state", "set_rng_state", "get_comms", "set_comms",
           "comms_initialized", "get_subcomm", "set_subcomm",
           "get_workspace_limit", "set_workspace_limit", "get_memory_stats",
           "get_cancel_token", "sync", "DeviceResourcesManager",
           "DeviceResourcesSNMG"]

DEFAULT_DEVICE = "cuda:0"
DEFAULT_WORKSPACE = 1 << 30


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


class ResourceType(enum.Enum):
    """Vocabulary of resource slots, the reference package's."""

    DEVICE = "device"                       # torch.device
    MESH = "mesh"                           # DeviceMesh
    PRNG = "prng"                           # RngState
    COMMS = "comms"                         # MeshComms
    SUB_COMMS = "sub_comms"                 # dict key -> MeshComms
    WORKSPACE = "workspace"                 # workspace byte limit
    LARGE_WORKSPACE = "large_workspace"
    MEMORY_STATS = "memory_stats"
    LOGGER = "logger"
    CANCEL_TOKEN = "cancel_token"           # interruptible.CancelToken
    MULTI_DEVICE = "multi_device"           # list of per-device handles
    DONATION = "donation"


class ResourceFactory:
    """Builds one resource on first access."""

    def __init__(self, key: ResourceType, fn: Callable[[], Any]):
        self.key = key
        self.fn = fn

    def make_resource(self) -> Any:
        return self.fn()


class Resources:
    """Lazily built, thread-safe resource registry. Copies (``other``)
    share the factory and resource tables and their lock."""

    def __init__(self, other: Optional["Resources"] = None):
        if other is not None:
            self._lock = other._lock
            self._factories = other._factories
            self._resources = other._resources
        else:
            self._lock = threading.RLock()
            self._factories: Dict[ResourceType, ResourceFactory] = {}
            self._resources: Dict[ResourceType, Any] = {}

    def add_resource_factory(self, factory: ResourceFactory) -> None:
        with self._lock:
            self._factories[factory.key] = factory
            # a new factory invalidates a resource built by the old one
            self._resources.pop(factory.key, None)

    def has_resource_factory(self, key: ResourceType) -> bool:
        with self._lock:
            return key in self._factories

    def get_resource(self, key: ResourceType) -> Any:
        with self._lock:
            if key not in self._resources:
                if key not in self._factories:
                    raise KeyError(
                        f"no resource factory registered for {key!r}; "
                        f"register one with add_resource_factory()")
                self._resources[key] = self._factories[key].make_resource()
            return self._resources[key]

    def set_resource(self, key: ResourceType, value: Any) -> None:
        """Install a built resource directly."""
        with self._lock:
            self._factories[key] = ResourceFactory(key, lambda: value)
            self._resources[key] = value

    def _slot(self, key: ResourceType) -> Any:
        """The slot's resource, or None where no factory is registered."""
        with self._lock:
            return (self.get_resource(key) if key in self._factories
                    else None)


# -- accessors: one per resource, registering a default factory on demand --

def get_device(res: Resources) -> torch.device:
    """Target device; ``cuda:0`` unless one was set."""
    if not res.has_resource_factory(ResourceType.DEVICE):
        res.set_resource(ResourceType.DEVICE, resolve_device(None))
    return res.get_resource(ResourceType.DEVICE)


def set_device(res: Resources, device) -> None:
    res.set_resource(ResourceType.DEVICE, resolve_device(device))


def get_mesh(res: Resources):
    """Device mesh for multi-rank execution: the one set with
    :func:`set_mesh`, else (made once) a 1-D mesh named ``"data"`` over
    every rank of the default process group, on the handle's device
    type. With no process group up, a world of size 1 is started first
    (:func:`raft_tpu_torch.comms.bootstrap.initialize_distributed`:
    NCCL for a CUDA handle, gloo for a CPU one)."""
    mesh = res._slot(ResourceType.MESH)
    if mesh is None:
        mesh = _world_mesh(get_device(res), "data")
        set_mesh(res, mesh)
    return mesh


def _world_mesh(dev: torch.device, axis_name: str):
    """A 1-D mesh named ``axis_name`` over every rank of the default
    process group (started with world size 1 where none is up)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from raft_tpu_torch.comms import bootstrap

    if not dist.is_initialized():
        bootstrap.initialize_distributed(
            num_processes=1, process_id=0,
            backend="nccl" if dev.type == "cuda" else "gloo")
    bootstrap.check_backend(dev.type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def set_mesh(res: Resources, mesh) -> None:
    res.set_resource(ResourceType.MESH, mesh)


def get_rng_state(res: Resources) -> RngState:
    """Per-handle generator state (seed 0 unless one was set)."""
    if not res.has_resource_factory(ResourceType.PRNG):
        res.add_resource_factory(
            ResourceFactory(ResourceType.PRNG, lambda: RngState(seed=0)))
    return res.get_resource(ResourceType.PRNG)


def set_rng_state(res: Resources, state: RngState) -> None:
    res.set_resource(ResourceType.PRNG, state)


def get_comms(res: Resources):
    """Communicator injected into the handle. Raises if none was set,
    as the reference's: algorithms require ``build_mesh_comms`` (or a
    bootstrap injection) to have run first."""
    comms = res._slot(ResourceType.COMMS)
    if comms is None:
        raise RuntimeError(
            "no communicator set on this handle; call "
            "raft_tpu_torch.comms.build_mesh_comms(res, mesh) first")
    return comms


def set_comms(res: Resources, comms) -> None:
    res.set_resource(ResourceType.COMMS, comms)


def comms_initialized(res: Resources) -> bool:
    return res._slot(ResourceType.COMMS) is not None


def _subcomm_table(res: Resources) -> dict:
    if not res.has_resource_factory(ResourceType.SUB_COMMS):
        res.set_resource(ResourceType.SUB_COMMS, {})
    return res.get_resource(ResourceType.SUB_COMMS)


def get_subcomm(res: Resources, key: str):
    """Keyed sub-communicator."""
    table = _subcomm_table(res)
    if key not in table:
        raise KeyError(f"no sub-communicator registered under key {key!r}")
    return table[key]


def set_subcomm(res: Resources, key: str, comms) -> None:
    _subcomm_table(res)[key] = comms


def get_workspace_limit(res: Resources) -> int:
    """Soft byte cap primitives consult when sizing scratch buffers
    (1 GiB unless set); PyTorch's caching allocator owns the memory."""
    if not res.has_resource_factory(ResourceType.WORKSPACE):
        res.set_resource(ResourceType.WORKSPACE, DEFAULT_WORKSPACE)
    return res.get_resource(ResourceType.WORKSPACE)


def set_workspace_limit(res: Resources, nbytes: int) -> None:
    res.set_resource(ResourceType.WORKSPACE, int(nbytes))


def get_memory_stats(res: Resources) -> dict:
    """The handle's device memory in bytes, under the reference's keys
    (:func:`raft_tpu_torch.core.memory.device_memory_stats`):
    ``bytes_in_use`` (``torch.cuda.memory_allocated``),
    ``peak_bytes_in_use`` (``max_memory_allocated``) and ``bytes_limit``
    (the card's total); zeros on the CPU."""
    from raft_tpu_torch.core.memory import device_memory_stats

    return device_memory_stats(get_device(res))


def get_cancel_token(res: Resources):
    """The handle's cooperative-cancellation token."""
    if not res.has_resource_factory(ResourceType.CANCEL_TOKEN):
        from raft_tpu_torch.core.interruptible import CancelToken

        res.set_resource(ResourceType.CANCEL_TOKEN, CancelToken())
    return res.get_resource(ResourceType.CANCEL_TOKEN)


def sync(res: Resources, *arrays) -> None:
    """Wait for the work queued on the handle's stream (nothing on the
    CPU), polling the handle's cancel token before and after.
    ``arrays`` are accepted for the reference's signature: every tensor
    the handle produced was queued on that stream."""
    token = get_cancel_token(res)
    token.check()
    dev = get_device(res)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    token.check()


# -- the user-facing handle --------------------------------------------------

class DeviceResources(Resources):
    """Resources with the device, mesh and generator state registered.
    ``other`` shares another handle's tables (the reference's copy
    constructor); ``mesh`` is a ``DeviceMesh`` for multi-rank work
    (:func:`get_mesh`)."""

    def __init__(self, device: Union[str, torch.device, None] = None,
                 mesh=None, seed: int = 0,
                 other: Optional[Resources] = None):
        super().__init__(other)
        if other is None:
            set_device(self, device)
            if mesh is not None:
                set_mesh(self, mesh)
            set_rng_state(self, RngState(seed=seed))

    @property
    def device(self) -> torch.device:
        return get_device(self)

    @property
    def mesh(self):
        return get_mesh(self)

    @mesh.setter
    def mesh(self, mesh) -> None:
        set_mesh(self, mesh)

    @property
    def rng_state(self) -> RngState:
        return get_rng_state(self)

    @rng_state.setter
    def rng_state(self, state: RngState) -> None:
        set_rng_state(self, state)

    @property
    def comms(self):
        """The injected communicator, or None."""
        return self._slot(ResourceType.COMMS)

    @comms.setter
    def comms(self, comms) -> None:
        set_comms(self, comms)

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
        sync(self, *arrays)

    def __repr__(self):
        return f"DeviceResources(device={self.device}, {self.rng_state})"


def device_resources(device: Union[str, torch.device, None] = None,
                     mesh=None, seed: int = 0) -> DeviceResources:
    """Create a handle; ``device=None`` is ``cuda:0``."""
    return DeviceResources(device=device, mesh=mesh, seed=seed)


# the reference's deprecated alias of the handle
Handle = DeviceResources


class DeviceResourcesManager:
    """Process-wide pool of handles, one per (device, thread), with
    settable defaults applied to newly built handles."""

    def __init__(self):
        self._lock = threading.Lock()
        self._handles: Dict[Any, DeviceResources] = {}
        self._default_seed = 0
        self._default_workspace = DEFAULT_WORKSPACE
        self._default_mesh = None

    def set_seed(self, seed: int) -> None:
        with self._lock:
            self._default_seed = seed

    def set_workspace_limit(self, nbytes: int) -> None:
        with self._lock:
            self._default_workspace = int(nbytes)

    def set_mesh(self, mesh) -> None:
        with self._lock:
            self._default_mesh = mesh

    def get_device_resources(self, device=None) -> DeviceResources:
        """The cached handle of ``device`` (``cuda:0`` by default) for
        the calling thread."""
        dev = resolve_device(device)
        key = (dev, threading.get_ident())
        with self._lock:
            if key not in self._handles:
                h = DeviceResources(device=dev, mesh=self._default_mesh,
                                    seed=self._default_seed)
                set_workspace_limit(h, self._default_workspace)
                self._handles[key] = h
            return self._handles[key]


_manager = DeviceResourcesManager()


def get_device_resources(device=None) -> DeviceResources:
    """The process-wide cached handle of ``device`` for this thread."""
    return _manager.get_device_resources(device)


def default_resources(res: Optional[Resources] = None) -> DeviceResources:
    """``res``, or the process-wide handle for ``cuda:0``."""
    return res if res is not None else get_device_resources()


def as_tensor(x, res: Optional[Resources] = None) -> torch.Tensor:
    """The input rule of every entry point: a tensor stays on its device;
    anything else (a numpy array, a list) goes to the handle's device,
    ``cuda:0`` by default, which raises :class:`DeviceUnavailableError`
    without CUDA."""
    if isinstance(x, torch.Tensor):
        return x
    import numpy as np

    return torch.as_tensor(np.asarray(x),
                           device=get_device(default_resources(res)))


class DeviceResourcesSNMG(DeviceResources):
    """Single-process multi-device handle: a root handle plus one child
    handle per device, each with its rank view of one clique.

    A process of the port drives one rank of a ``torch.distributed``
    world, so the clique is the default process group's (a world of size
    1 is started where none is up) and ``devices`` must name as many
    devices as it has ranks: on one card, one. ``devices`` defaults to
    ``cuda:0``."""

    def __init__(self, devices=None, seed: int = 0,
                 axis_name: str = "data"):
        devs = [resolve_device(d) for d in
                (devices if devices is not None else [None])]
        if not devs:
            raise ValueError("no devices for SNMG handle")
        import torch.distributed as dist

        from raft_tpu_torch.comms.bootstrap import inject_comms_on_handle

        mesh = _world_mesh(devs[0], axis_name)
        if len(devs) != dist.get_world_size():
            raise ValueError(
                f"{len(devs)} devices for a clique of "
                f"{dist.get_world_size()} rank(s): a process of the port "
                "drives one rank of the process group")
        super().__init__(device=devs[0], mesh=mesh, seed=seed)
        self._axis_name = axis_name
        self._children = [DeviceResources(device=d, mesh=mesh, seed=seed + i)
                          for i, d in enumerate(devs)]
        shared = mailbox = None
        for rank, child in enumerate(self._children):
            view = inject_comms_on_handle(child, mesh, axis_name, rank,
                                          _shared=shared, _mailbox=mailbox)
            shared, mailbox = view._shared, view._mailbox
        set_comms(self, get_comms(self._children[0]))

    @property
    def n_ranks(self) -> int:
        return len(self._children)

    def rank_resources(self, rank: int) -> DeviceResources:
        """Child handle of one rank."""
        return self._children[rank]

    def __iter__(self):
        return iter(self._children)

    def set_memory_pool(self, percent_of_free: int) -> None:
        """Accepted for the reference's signature and ignored, as there:
        PyTorch's caching allocator owns device memory."""

