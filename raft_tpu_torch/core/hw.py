"""Per-backend hardware peak table: the denominator of every roofline
fraction (counterpart of ``raft_tpu/core/hw.py``).

One module owns the device peaks the performance-attribution layer
(:mod:`raft_tpu_torch.obs.perf`) divides achieved FLOP/s and bytes/s by,
so a "0.31 of roofline" claim always names the ceiling it was measured
against. Two tables live here:

* :data:`CUDA_PEAKS`: theoretical peaks (bf16 tensor-core FLOP/s, HBM
  bytes/s) of the CUDA cards this port is tuned for, matched against
  ``torch.cuda.get_device_name``. An H100 SXM is 989e12 bf16 FLOP/s
  (dense) and 3.35e12 B/s, the figures ``PERF.md`` bounds every kernel
  by. Any other CUDA card gets the generic :data:`GPU_PEAKS`.
* :data:`SUSTAINED_FLOP_S` / :data:`SUSTAINED_BYTES_S`: the coarse
  order-of-magnitude sustained throughputs ``runtime/limits.py`` uses to
  seed its fast-fail chunk-seconds estimates (limits re-exports them).

The reference's TPU generation table has no counterpart: the port runs
on CUDA cards and the CPU only.

``RAFT_TPU_PERF_PEAKS=flops=<num>,bytes=<num>`` overrides the detected
peaks (either term alone overrides just that axis): the escape hatch for
a card this table predates. A malformed value raises at the read site.

This module imports only ``core/env`` (torch is touched lazily inside
:func:`peaks`), so obs, limits and the serving layer can all use it
without cycles.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

from raft_tpu_torch.core import env as _env_mod

__all__ = ["HwPeaks", "peaks", "backend_of", "CUDA_PEAKS", "CPU_PEAKS",
           "GPU_PEAKS", "SUSTAINED_FLOP_S", "SUSTAINED_BYTES_S"]


@dataclass(frozen=True)
class HwPeaks:
    """One device's roofline ceilings: peak FLOP/s (bf16 tensor cores on
    a CUDA card), peak device-memory bytes/s, and where the numbers came
    from (``"table"``: the tables below; ``"fallback"``: an unknown
    backend; ``"env"``: a ``RAFT_TPU_PERF_PEAKS`` override)."""

    name: str
    flops_per_s: float
    bytes_per_s: float
    source: str = "table"


# Per-card theoretical peaks, matched first-fragment-first against the
# lowercased device name (e.g. "nvidia h100 80gb hbm3"). FLOP/s: dense
# bf16 tensor-core peak; bytes/s: HBM bandwidth.
CUDA_PEAKS: Tuple[Tuple[str, HwPeaks], ...] = (
    ("h100 80gb hbm3", HwPeaks("h100-sxm", 989e12, 3.35e12)),
    ("h100 sxm", HwPeaks("h100-sxm", 989e12, 3.35e12)),
)

# CPU: the order-of-magnitude sustained figures of the limits cost model;
# a host test backend has no stable theoretical peak worth pretending to.
CPU_PEAKS = HwPeaks("cpu", 5e10, 2e10)
GPU_PEAKS = HwPeaks("gpu", 5e13, 1e12)

# Coarse sustained throughputs for the limits fast-fail chunk-seconds
# model (limits re-exports these). Below theoretical peak on purpose:
# they seed an admission decision, not a measurement.
SUSTAINED_FLOP_S = {"cpu": 5e10, "gpu": 5e13}
SUSTAINED_BYTES_S = {"cpu": 2e10, "gpu": 1e12}


def backend_of(device=None) -> str:
    """The backend name of the sustained tables and the cost models for a
    torch device (or its spelling): ``cuda`` -> ``"gpu"``, ``cpu`` ->
    ``"cpu"``; with no device, ``"gpu"`` when CUDA is up, else
    ``"cpu"``."""
    import torch

    if device is None:
        return "gpu" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    return "gpu" if dev.type == "cuda" else dev.type


def _cuda_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device)


def _detect(device=None, backend: Optional[str] = None) -> HwPeaks:
    name = ""
    if backend is None or device is not None:
        import torch

        if device is None:
            device = "cuda:0" if backend_of() == "gpu" else "cpu"
        device = torch.device(device)
        backend = backend_of(device)
        if backend == "gpu":
            name = (_cuda_name(device) or "").lower()
    if backend == "gpu":
        for frag, pk in CUDA_PEAKS:
            if frag in name:
                return pk
        return GPU_PEAKS
    if backend == "cpu":
        return CPU_PEAKS
    return replace(CPU_PEAKS, name=backend or "unknown", source="fallback")


def peaks(device=None, *, backend: Optional[str] = None) -> HwPeaks:
    """Roofline ceilings for ``device`` (a torch device or its spelling;
    default ``cuda:0`` when CUDA is up, else the CPU). ``backend`` alone
    (``"gpu"`` or ``"cpu"``) skips device inspection, the spelling limits
    and tests use. ``RAFT_TPU_PERF_PEAKS`` terms override the detected
    values and raise at this read on a malformed spelling."""
    pk = _detect(device, backend)
    override = _env_mod.read("RAFT_TPU_PERF_PEAKS")
    if override:
        pk = HwPeaks(pk.name,
                     override.get("flops", pk.flops_per_s),
                     override.get("bytes", pk.bytes_per_s),
                     source="env")
    return pk
