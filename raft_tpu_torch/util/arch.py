"""The card's architecture and capability figures (counterpart of
``raft_tpu/util/arch.py``).

The reference package gates kernel variants on the TPU generation; the
port's names keep their parameters and mean the card's counterparts:
``gen`` is the SM version (90 on an H100, 0 for the CPU and unknown
kinds, which sort below every card, as the reference's non-TPU kinds
do), and the capability figures are read from
``torch.cuda.get_device_properties`` or from the port's kernel sources.
No TPU figure is carried over.

>>> ArchRange(min_gen=80).contains(TpuArch("NVIDIA H100", (9, 0)))
True
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional, Tuple

import torch

_WGMMA_TILE = Path(__file__).resolve().parents[1] / "csrc" / "wgmma_tile.cuh"


class TpuArch:
    """One card architecture. ``gen`` is the SM version, ``major * 10 +
    minor`` of ``capability`` where given, else parsed from an
    ``sm_NN`` in ``device_kind`` (``"sm_90a"``), else 0. ``lite`` (the
    reference's TPU e-line) has no counterpart among CUDA cards and is
    False."""

    def __init__(self, device_kind: str,
                 capability: Optional[Tuple[int, int]] = None):
        self.device_kind = str(device_kind)
        if capability is not None:
            self.gen = int(capability[0]) * 10 + int(capability[1])
        else:
            m = re.search(r"sm_?(\d+)", self.device_kind.lower())
            self.gen = int(m.group(1)) if m else 0
        self.lite = False

    def __repr__(self):
        return f"TpuArch({self.device_kind!r}: gen={self.gen})"

    def __eq__(self, other):
        return isinstance(other, TpuArch) and self.gen == other.gen

    def __hash__(self):
        return hash(self.gen)


def runtime_arch() -> TpuArch:
    """The architecture of ``cuda:0`` (its name and compute capability);
    gen 0 where the process has no CUDA."""
    if not torch.cuda.is_available():
        return TpuArch("cpu")
    return TpuArch(torch.cuda.get_device_name(0),
                   torch.cuda.get_device_capability(0))


class ArchRange:
    """Inclusive SM-version gate [min_gen, max_gen]. ``contains`` admits
    gen 0 (the CPU, unknown kinds) only when ``allow_unknown``."""

    def __init__(self, min_gen: int = 0, max_gen: Optional[int] = None,
                 allow_unknown: bool = True):
        self.min_gen = min_gen
        self.max_gen = max_gen
        self.allow_unknown = allow_unknown

    def contains(self, arch: TpuArch) -> bool:
        if arch.gen == 0:
            return self.allow_unknown
        if arch.gen < self.min_gen:
            return False
        return self.max_gen is None or arch.gen <= self.max_gen


def _properties(device):
    from raft_tpu_torch.core.resources import DeviceUnavailableError, \
        resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise DeviceUnavailableError(
            f"the capability figures are a CUDA card's; got {dev}")
    return torch.cuda.get_device_properties(dev)


def vmem_bytes(arch: Optional[TpuArch] = None, device=None) -> int:
    """The on-chip memory one block may hold: the card's opt-in shared
    memory per block (``shared_memory_per_block_optin``; 227 KiB on
    sm_90), read from ``device`` (``cuda:0`` by default). ``arch`` is
    accepted for the reference's signature; the figure is the
    device's."""
    del arch
    return int(_properties(device).shared_memory_per_block_optin)


def mxu_dim(arch: Optional[TpuArch] = None) -> int:
    """The edge of the port's tensor-core tile: ``kBN``, the wgmma N
    (and ``kBM``) of ``csrc/wgmma_tile.cuh``."""
    del arch
    m = re.search(r"constexpr int kBN = (\d+);", _WGMMA_TILE.read_text())
    return int(m.group(1))


def vreg_shape(arch: Optional[TpuArch] = None, device=None) -> tuple:
    """(rows, lanes) of one register across a warp: one 32-bit value in
    each of the warp's lanes (``warp_size``, 32 on every CUDA card), read
    from ``device`` (``cuda:0`` by default)."""
    del arch
    return (1, int(getattr(_properties(device), "warp_size", 32)))
