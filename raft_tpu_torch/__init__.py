"""raft_tpu_torch: the PyTorch/CUDA port of ``raft_tpu``.

The port mirrors ``raft_tpu`` module for module, with the same public
names, and runs on an NVIDIA Hopper card (``sm_90a``). Every Pallas
kernel of the reference package on a ported path becomes a CUDA C++
kernel written by hand (``raft_tpu_torch/csrc``), built at first use
with ``nvcc`` and bound through ``ctypes`` (``raft_tpu_torch.kernels``).

Device rule: entry points run on the card. ``device_resources()`` and
``default_resources()`` default to ``cuda:0`` and raise
:class:`~raft_tpu_torch.core.resources.DeviceUnavailableError` when CUDA
is absent, unless the caller asks for ``device="cpu"``. Functions that
take tensors follow the tensor's device: a CPU tensor runs the kernel's
plain PyTorch version, a CUDA tensor launches the kernel or raises.

Ported so far (one device; the comms layer and the MNMG Lloyd step with
one rank a process over ``torch.distributed``):

linalg.contractions : pairwise tile, fused argmin, fused Lloyd pass
distance            : pairwise_distance (expanded metrics), fused_l2_nn_argmin
cluster             : k-means (Lloyd, k-means|| init)
neighbors           : brute-force kNN (fused top-k, radix and scan routes)
matrix              : select_k (radix, insertion, tiled, stream, direct),
                      argmin, argmax, gather, linewise_op, matrix.ops
sparse              : CSR/COO types, convert, op, SpMV/SpMM (CSR kernels),
                      linalg (Laplacian, symmetrize, ...), Lanczos eigsh
spectral            : partition, modularity_maximization, analyzers
random              : RngState (with the key API), the distributions,
                      sampling, permute, make_blobs, make_regression,
                      multi_variable_gaussian, rmat_rectangular_gen
label               : classlabels, merge_labels
stats               : moments, histogram, information criteria, the
                      clustering scores, silhouette, trustworthiness
comms               : MeshComms, build_mesh_comms, comms.device (NCCL for
                      CUDA tensors, gloo for CPU tensors), bootstrap, the
                      self-test battery; with core.{logger, trace,
                      interruptible}, obs and runtime.limits
cluster (MNMG)      : mnmg_lloyd_step
core (host)         : the resource registry, memory types, mdarray,
                      serialize (.npy), memory observability, the native
                      host runtime (g++ at first use)
util                : input checks, integer math, arch, the precision
                      ladder, the vector caches
solver              : the auction linear assignment solver

The package imports neither ``jax`` nor ``raft_tpu``.
"""

__version__ = "0.1.0"

from raft_tpu_torch.core.resources import (  # noqa: F401
    DeviceResources,
    DeviceUnavailableError,
    default_resources,
    device_resources,
)
