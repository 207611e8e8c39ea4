"""Registry of the port's hand-written CUDA kernels and their launch
counters.

Each entry names the CUDA source, the C entry point and its argument
types, the plain PyTorch version of the same function, the ``raft_tpu``
Pallas kernels it replaces, and the test that holds it against the
reference package. The kernels are built at first use
(:mod:`raft_tpu_torch.kernels.build`); importing this package needs no
``nvcc`` and no CUDA.

A wrapper adds one to its kernel's counter each time it launches the
kernel, and nowhere else, so a run can show that a path went through
the kernels (:func:`reset_launch_counts`, :func:`launch_counts`). A
launch recorded into a CUDA graph under capture launches nothing then:
it goes to the capture's tally (:func:`capture_launches`), and each
replay of the graph adds the tally to the counters
(:func:`count_replay`), so replayed kernels are counted as they run.
A masked step of a chunk is launched or captured under a device flag
(:func:`gated`); a kernel that takes a gate (``fused_lloyd``) reads it
(:func:`gate_ptr`) and does no work where it is 0.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import threading
from typing import Dict, Iterator, Tuple

__all__ = ["KernelSpec", "KernelLaunchError", "REGISTRY", "launch",
           "launch_counts", "reset_launch_counts", "capture_launches",
           "count_replay", "gated", "gate_ptr"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64

# (x0, x1, xn, ldx, y0, y1, yn, ldy): the operand block every entry point
# takes after its tier (and metric); see csrc/common.cuh
_OPERANDS = (_P, _P, _P, _L, _P, _P, _P, _L)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    name: str
    source: str             # relative to raft_tpu_torch/
    symbol: str             # extern "C" entry point
    argtypes: Tuple
    plain: str              # dotted path of the plain PyTorch version
    ports: str              # the raft_tpu Pallas kernels it replaces
    replaces: str           # file:line of the (first) TPU kernel body
    parity_test: str        # test holding it against the reference


REGISTRY: Dict[str, KernelSpec] = {
    spec.name: spec for spec in (
        KernelSpec(
            name="pairwise_tile",
            source="csrc/pairwise_tile.cu",
            symbol="raft_pairwise_tile",
            # tier, metric, operands..., out, m, n, k, stream
            argtypes=(_I, _I) + _OPERANDS + (_P, _I, _I, _I, _P),
            plain="raft_tpu_torch.linalg.contractions._pairwise_plain",
            ports="raft_tpu/linalg/contractions.py:_pairwise_tile_kernel, "
                  "_pairwise_tile_kernel_split",
            replaces="raft_tpu/linalg/contractions.py:360",
            parity_test="tests/test_torch_contractions.py"
                        "::test_pairwise_matches_reference"),
        KernelSpec(
            name="fused_argmin",
            source="csrc/fused_argmin.cu",
            symbol="raft_fused_argmin",
            # tier, metric, operands..., m, n, k, splits, flat, grid,
            # part_v, part_i, val, idx, stream
            argtypes=(_I, _I) + _OPERANDS + (_I, _I, _I, _I, _I, _I, _P, _P,
                                             _P, _P, _P),
            plain="raft_tpu_torch.linalg.contractions._argmin_plain",
            ports="raft_tpu/linalg/contractions.py:_argmin_resident_kernel"
                  "(_split), _argmin_tiled_kernel(_split)",
            replaces="raft_tpu/linalg/contractions.py:665",
            parity_test="tests/test_torch_contractions.py"
                        "::test_fused_argmin_matches_reference"),
        KernelSpec(
            name="fused_lloyd",
            source="csrc/fused_lloyd.cu",
            symbol="raft_fused_lloyd",
            # tier, operands..., sums, counts, val, idx, iscr, part,
            # grid, m, n, kd, k, chunk, gate, stream
            argtypes=(_I,) + _OPERANDS + (_P, _P, _P, _P, _P, _P, _I, _I,
                                          _I, _I, _I, _I, _P, _P),
            plain="raft_tpu_torch.linalg.contractions._lloyd_plain",
            ports="raft_tpu/linalg/contractions.py:_lloyd_kernel, "
                  "_lloyd_kernel_split",
            replaces="raft_tpu/linalg/contractions.py:931",
            parity_test="tests/test_torch_contractions.py"
                        "::test_fused_lloyd_matches_reference"),
        KernelSpec(
            name="fused_topk",
            source="csrc/fused_topk.cu",
            symbol="raft_fused_topk",
            # tier, metric, operands..., m, n, kd, k, splits, grid, lists,
            # out_v, out_i, stream
            argtypes=(_I, _I) + _OPERANDS + (_I, _I, _I, _I, _I, _I, _P, _P,
                                             _P, _P),
            plain="raft_tpu_torch.neighbors.fused_topk._fused_topk_plain",
            ports="raft_tpu/neighbors/fused_topk.py:_topk_kernel, "
                  "_topk_kernel_split",
            replaces="raft_tpu/neighbors/fused_topk.py:102",
            parity_test="tests/test_torch_knn.py"
                        "::test_knn_fused_matches_reference"),
        KernelSpec(
            name="topk_insert",
            source="csrc/topk_insert.cu",
            symbol="raft_topk_insert",
            # dtype, select_min, v, ld, rows, len, k, out_v, out_i, stream
            argtypes=(_I, _I, _P, _L, _I, _I, _I, _P, _P, _P),
            plain="raft_tpu_torch.matrix.topk_insert._insert_plain",
            ports="raft_tpu/matrix/topk_insert.py:_insert_kernel",
            replaces="raft_tpu/matrix/topk_insert.py:48",
            parity_test="tests/test_torch_select_k.py"
                        "::test_insert_select_matches_reference"),
        KernelSpec(
            name="radix_threshold",
            source="csrc/radix_threshold.cu",
            symbol="raft_radix_threshold",
            # keys, ld, rows, len, k, form, span, hist, cand, cap, t, ntie,
            # stream
            argtypes=(_P, _L, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P),
            plain="raft_tpu_torch.matrix.radix_select._threshold_plain",
            ports="raft_tpu/matrix/radix_select.py:_threshold_kernel",
            replaces="raft_tpu/matrix/radix_select.py:235",
            parity_test="tests/test_torch_radix_select.py"
                        "::test_radix_ranks_match_reference"),
        KernelSpec(
            name="radix_emit",
            source="csrc/radix_emit.cu",
            symbol="raft_radix_emit",
            # keys, ld, rows, len, k, t, ntie, splits, scratch, out, stream
            argtypes=(_P, _L, _I, _I, _I, _P, _P, _I, _P, _P, _P),
            plain="raft_tpu_torch.matrix.radix_select._emit_plain",
            ports="raft_tpu/matrix/radix_select.py:_emit_kernel, "
                  "_emit_chunk_body",
            replaces="raft_tpu/matrix/radix_select.py:332",
            parity_test="tests/test_torch_radix_select.py"
                        "::test_radix_ranks_match_reference"),
        KernelSpec(
            name="csr_spmv",
            source="csrc/csr_spmv.cu",
            symbol="raft_csr_spmv",
            # dtype, idx64, indptr, indices, data, x, y, n_rows, n_chunks,
            # seg_len, lpe, owner, part, stream
            argtypes=(_I, _I, _P, _P, _P, _P, _P, _I, _L, _I, _I, _P, _P,
                      _P),
            plain="raft_tpu_torch.sparse.grid_spmv._spmv_plain",
            ports="raft_tpu/sparse/grid_spmv.py:_tree_gather_kernel, "
                  "_segsum_kernel, _reduce_kernel",
            replaces="raft_tpu/sparse/grid_spmv.py:426",
            parity_test="tests/test_torch_sparse.py"
                        "::test_spmv_matches_reference"),
        KernelSpec(
            name="csr_spmm",
            source="csrc/csr_spmm.cu",
            symbol="raft_csr_spmm",
            # dtype, idx64, indptr, indices, data, b, ldb, c, ldc, n_rows,
            # k, n_chunks, seg_len, part, stream
            argtypes=(_I, _I, _P, _P, _P, _P, _L, _P, _L, _I, _I, _L, _I,
                      _P, _P),
            plain="raft_tpu_torch.sparse.grid_spmv._spmm_plain",
            ports="raft_tpu/sparse/grid_spmv.py:_gather_kt_kernel, "
                  "_segsum_kt_kernel, _reduce_kt_kernel",
            replaces="raft_tpu/sparse/grid_spmv.py:653",
            parity_test="tests/test_torch_sparse.py"
                        "::test_spmm_matches_reference"),
        KernelSpec(
            name="unexpanded_tile",
            source="csrc/unexpanded_tile.cu",
            symbol="raft_unexpanded_tile",
            # dtype, metric, p_bits, x, ldx, y, ldy, out, m, n, k, stream
            argtypes=(_I, _I, _L, _P, _L, _P, _L, _P, _I, _I, _I, _P),
            plain="raft_tpu_torch.linalg.contractions.unexpanded_ref",
            ports="raft_tpu/linalg/contractions.py:_unexpanded_tile_kernel",
            replaces="raft_tpu/linalg/contractions.py:525",
            parity_test="tests/test_torch_unexpanded.py"
                        "::test_unexpanded_matches_reference"),
        KernelSpec(
            name="mst_min_edge",
            source="csrc/mst_min_edge.cu",
            symbol="raft_mst_min_edge",
            # dtype, idx64, indptr, indices, data, colors, n_cols, out_w,
            # out_key, out_eid, n_rows, n_chunks, seg_len, lpe, owner,
            # part_w, part_key, part_eid, stream
            argtypes=(_I, _I, _P, _P, _P, _P, _L, _P, _P, _P, _I, _L, _I, _I,
                      _P, _P, _P, _P, _P),
            plain="raft_tpu_torch.sparse.solver.mst_grid._min_edge_plain",
            ports="raft_tpu/sparse/solver/mst_grid.py:_mst_scan_kernel, "
                  "_mst_reduce_kernel, grid_spmv._tree_gather_kernel "
                  "(colors[dst])",
            replaces="raft_tpu/sparse/solver/mst_grid.py:139",
            parity_test="tests/test_torch_mst.py"
                        "::test_mst_matches_reference"),
        KernelSpec(
            name="minonly",
            source="csrc/minonly.cu",
            symbol="raft_minonly",
            # tier, operands..., m, n, k, splits, grid, part_v, part_i,
            # val, idx, stream
            argtypes=(_I,) + _OPERANDS + (_I, _I, _I, _I, _I, _P, _P, _P,
                                          _P, _P),
            plain="raft_tpu_torch.neighbors.fused_topk._minonly_plain",
            ports="raft_tpu/neighbors/fused_topk.py:_minonly_kernel, "
                  "_minonly_kernel_split",
            replaces="raft_tpu/neighbors/fused_topk.py:195",
            parity_test="tests/test_torch_knn.py"
                        "::test_minonly_probe_matches_reference"),
    )
}

_lock = threading.Lock()
_launches: Dict[str, int] = {name: 0 for name in REGISTRY}
_capture = threading.local()


class KernelLaunchError(RuntimeError):
    """A kernel's C entry point returned a CUDA error."""


def launch_counts() -> Dict[str, int]:
    with _lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        for name in _launches:
            _launches[name] = 0


@contextlib.contextmanager
def capture_launches() -> Iterator[Dict[str, int]]:
    """While a CUDA graph is captured on this thread: the dict the
    captured launches are tallied into instead of the counters."""
    prev = getattr(_capture, "tally", None)
    tally: Dict[str, int] = {}
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = prev


def count_replay(tally: Dict[str, int]) -> None:
    """Count the launches of one replay of a graph whose capture tallied
    ``tally``."""
    with _lock:
        for name, n in tally.items():
            _launches[name] += n


@contextlib.contextmanager
def gated(flag) -> Iterator[None]:
    """While a masked step is launched or captured on this thread:
    ``flag``, a 0-d int32 tensor on the card, is the gate of the kernels
    that take one: where it is 0 when they run, they return at once
    (their outputs are left as they were, and the masked step discards
    them)."""
    prev = getattr(_capture, "gate", None)
    _capture.gate = flag
    try:
        yield
    finally:
        _capture.gate = prev


def gate_ptr() -> int:
    """The address of the flag of :func:`gated` on this thread, else 0
    (a null gate: the kernel always runs)."""
    flag = getattr(_capture, "gate", None)
    return 0 if flag is None else flag.data_ptr()


def launch(name: str, device, *args) -> None:
    """Launch kernel ``name`` on ``device``'s current stream: ``args``
    are the entry point's arguments without the trailing stream. Raises
    :class:`KernelLaunchError` on a CUDA error and counts the launch
    (under :func:`capture_launches`, into the capture's tally)."""
    import torch

    from raft_tpu_torch.kernels import build

    fn = build.entry_point(REGISTRY[name])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise KernelLaunchError(f"{name}: CUDA error {err} at launch")
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        tally[name] = tally.get(name, 0) + 1
        return
    with _lock:
        _launches[name] += 1
