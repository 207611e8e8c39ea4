"""CSR SpMV and SpMM on the card (counterpart of
``raft_tpu/sparse/grid_spmv.py``).

========  =====================  ============  ===========================
product   CUDA kernel            plain version  replaces (grid_spmv.py)
========  =====================  ============  ===========================
y = A·x   csrc/csr_spmv.cu       _spmv_plain   _tree_gather_kernel,
                                               _segsum_kernel,
                                               _reduce_kernel
C = A·B   csrc/csr_spmm.cu       _spmm_plain   _gather_kt_kernel,
                                               _segsum_kt_kernel,
                                               _reduce_kt_kernel
========  =====================  ============  ===========================

The reference packs each sparsity pattern on the host into a slot grid,
because Mosaic's gather is lane-local and cannot read x at a column index
directly; its three kernels gather through a select tree, sum each row
with a segmented scan and accumulate row-window planes. A CUDA thread
reads x at any column, so each kernel here computes what three compute
together, straight from the CSR arrays. Neither gives a warp more than
:data:`SPMM_SEG` (SpMM) or :data:`SPMV_SEG` (SpMV) entries: a group of
lanes takes a row's first ones, a warp per chunk of the entries the rest
of long rows, so that a hub row spreads over many warps and short rows
fill the warp. The plan
(:class:`GridSpMV`) keeps the reference's role, "prepare once per
pattern, apply many times", and holds the CSR pattern on the device and,
from the first SpMV on, the row each entry chunk serves
(:func:`_spmv_owners`): no slot grid, no host pack, no shard width.

Contract (the reference's, ``grid_spmv.py:45-48``): products and sums in
f32, or in f64 where an operand is f64 (the reference's segment path
under ``jax_enable_x64``; its grid computes in f32 only); each row sums
its own entries only; a stored zero against x = inf gives NaN and no
other row sees it; entries past ``indptr[-1]`` (bucketing pads) are never
read; an empty row gives exactly 0. The kernels sum in one fixed order a
row, so two runs are bitwise equal; the plain versions (``index_add_``)
reassociate, and parity between them is to |y - y_ref| <= 2e-5 ·
(|A|·|x|)_row + 2e-5.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch import kernels
from raft_tpu_torch.core.resources import as_tensor

__all__ = ["GridSpMV", "prepare", "spmv", "spmm", "SPAN_WINDOWS"]

# The reference's emission range (tiles span at most this many 128-row
# windows); kept only to validate prepare()'s argument.
SPAN_WINDOWS = 8
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
# Entries a warp of csrc/csr_spmm.cu (csrc/csr_spmv.cu) takes at most: a
# row's first ones, or a chunk of the entry array.
SPMM_SEG = 256
SPMV_SEG = 256
# Entries a lane of csr_spmv's row groups takes in one step (its loads in
# flight together).
SPMV_UNROLL = 4


class GridSpMV:
    """Prepared SpMV/SpMM plan for one sparsity pattern: the CSR arrays on
    their device, ``indices`` int32. Build with :func:`prepare`; apply
    with :func:`spmv` / :func:`spmm`."""

    def __init__(self, *, indptr, indices, data, shape: Tuple[int, int],
                 nnz: int):
        self.indptr = indptr
        self.indices = indices
        self.data = data
        self.shape = shape
        self.nnz = nnz              # logical nnz
        self.pad_ratio = 1.0        # no slot grid: nothing is padded
        self._owners = None         # csr_spmv's chunk owners, at first use

    def spmv_owners(self) -> torch.Tensor:
        """csr_spmv's chunk owners for this pattern (:func:`_spmv_owners`),
        computed at first use and kept."""
        if self._owners is None:
            self._owners = _spmv_owners(self.indptr, self.indices.numel())
        return self._owners

    @property
    def n_rows(self):
        return self.shape[0]

    @property
    def n_cols(self):
        return self.shape[1]

    def matvec(self, x):
        return spmv(self, x)


def prepare(csr, span_windows: int = SPAN_WINDOWS,
            shard_w: int = None) -> GridSpMV:
    """The plan of a CSRMatrix. ``span_windows`` and ``shard_w`` are the
    reference's slot-grid knobs (the row-window span of a tile and the
    width of an x shard, both forced by Mosaic's lane-local gather); they
    are validated as there and choose nothing, since the kernels read the
    CSR arrays directly. Indices become int32 where they are not."""
    if int(span_windows) < 1:
        raise ValueError(f"span_windows must be >= 1, got {span_windows}")
    if shard_w is not None and (int(shard_w) < 128 or int(shard_w) % 128):
        raise ValueError(f"shard_w must be a positive multiple of 128, "
                         f"got {shard_w}")
    n_rows, n_cols = csr.shape
    if n_cols >= 1 << 31:
        raise ValueError(f"{n_cols} columns do not fit int32 indices")
    indices = csr.indices
    if indices.dtype != torch.int32:
        indices = indices.to(torch.int32)
    if csr.indptr.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"indptr must be int32 or int64, got "
                        f"{csr.indptr.dtype}")
    return GridSpMV(indptr=csr.indptr, indices=indices, data=csr.data,
                    shape=(n_rows, n_cols), nnz=csr.logical_nnz())


def _row_ids(indptr: torch.Tensor, n_rows: int, nnz: int) -> torch.Tensor:
    lengths = (indptr[1:] - indptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(n_rows, device=indptr.device), lengths,
        output_size=nnz)


def _spmv_plain(indptr, indices, data, x, n_rows: int) -> torch.Tensor:
    """The reference's segment formulation: ``data * x[indices]`` over the
    logical entries, ``index_add_`` by row id (``linalg.py:36-44``)."""
    nnz = int(indptr[-1])
    prod = data[:nnz] * x[indices[:nnz].long()]
    return torch.zeros(n_rows, dtype=prod.dtype, device=x.device).index_add_(
        0, _row_ids(indptr, n_rows, nnz), prod)


def _spmm_plain(indptr, indices, data, b, n_rows: int) -> torch.Tensor:
    """The segment formulation for B [n_cols, k] (``linalg.py:192-199``)."""
    nnz = int(indptr[-1])
    prods = data[:nnz, None] * b[indices[:nnz].long(), :]
    return torch.zeros((n_rows, b.shape[1]), dtype=prods.dtype,
                       device=b.device).index_add_(
        0, _row_ids(indptr, n_rows, nnz), prods)


def _checked(indptr, indices, data, v):
    """The device of the operands, and the operands made contiguous;
    raises on dtypes or devices the kernels do not take."""
    if data.dtype != v.dtype or data.dtype not in _DTYPE_CODE:
        raise TypeError(f"data and the dense operand must both be f32 or "
                        f"both f64, got {data.dtype} and {v.dtype}")
    if indices.dtype != torch.int32 or indptr.dtype not in (torch.int32,
                                                            torch.int64):
        raise TypeError("indices must be int32 and indptr int32 or int64")
    devs = {t.device for t in (indptr, indices, data, v)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: "
                         f"{sorted(map(str, devs))}")
    if v.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {v.device}")
    return v.device, indptr.contiguous(), indices.contiguous(), \
        data.contiguous(), v.contiguous()


def _spmv_lanes(n_entries: int, n_rows: int) -> int:
    """Lanes a row of csr_spmv's row groups: enough that a row of the mean
    length (physical entries over rows, host-known) takes two steps of
    :data:`SPMV_UNROLL` entries a lane, as a power of two in [1, 32]: 4 on
    BASELINE config 4's graph, the fastest of 1–8 there (PERF.md)."""
    want = n_entries / max(n_rows, 1) / (2 * SPMV_UNROLL)
    lpe = 1
    while lpe < want and lpe < 32:
        lpe *= 2
    return lpe


def _spmv_owners(indptr: torch.Tensor, n_entries: int) -> torch.Tensor:
    """csr_spmv's chunk owners: int32 [n_entries // SPMV_SEG + 1], for
    chunk c (the entries [c SPMV_SEG, (c + 1) SPMV_SEG)) the row holding
    entry c SPMV_SEG when that entry lies in a long row's tail (a row of
    more than SPMV_SEG entries, from the first chunk boundary at or after
    its start), else -1. Torch ops on indptr's device, no host sync; once
    per sparsity pattern."""
    seg = SPMV_SEG
    ip = indptr.long()
    n_rows = ip.numel() - 1
    first = torch.arange(n_entries // seg + 1, device=ip.device) * seg
    r = (torch.searchsorted(ip, first, right=True) - 1).clamp_(0, max(
        n_rows - 1, 0))
    s, e = ip[r], ip[r + 1]
    tail = (first < ip[-1]) & (e - s > seg) & (first >= s)
    return torch.where(tail, r, -1).to(torch.int32)


def _spmv(indptr, indices, data, x, n_rows: int,
          owners=None) -> torch.Tensor:
    """y = A·x: csrc/csr_spmv.cu on CUDA, the plain version on the CPU.
    ``owners``: the pattern's :func:`_spmv_owners`, computed here when not
    given."""
    dev, indptr, indices, data, x = _checked(indptr, indices, data, x)
    if dev.type == "cpu":
        return _spmv_plain(indptr, indices, data, x, n_rows)
    y = torch.empty(n_rows, dtype=x.dtype, device=dev)
    if n_rows:
        # one chunk warp (and partial) per SPMV_SEG physical entries: a
        # host-known bound on the logical entries' chunks, so no sync
        n_chunks = indices.numel() // SPMV_SEG + 1
        if owners is None:
            owners = _spmv_owners(indptr, indices.numel())
        if owners.shape != (n_chunks,) or owners.dtype != torch.int32:
            raise ValueError(f"owners must be int32 [{n_chunks}]")
        part = torch.empty(n_chunks, dtype=x.dtype, device=dev)
        kernels.launch("csr_spmv", dev, _DTYPE_CODE[x.dtype],
                       int(indptr.dtype == torch.int64), indptr.data_ptr(),
                       indices.data_ptr(), data.data_ptr(), x.data_ptr(),
                       y.data_ptr(), n_rows, n_chunks, SPMV_SEG,
                       _spmv_lanes(indices.numel(), n_rows),
                       owners.contiguous().data_ptr(), part.data_ptr())
    return y


def _spmm(indptr, indices, data, b, n_rows: int) -> torch.Tensor:
    """C = A·B for B [n_cols, k]: csrc/csr_spmm.cu on CUDA (k == 1 goes to
    csr_spmv.cu), the plain version on the CPU."""
    dev, indptr, indices, data, b = _checked(indptr, indices, data, b)
    k = b.shape[1]
    if k == 1:
        return _spmv(indptr, indices, data, b[:, 0], n_rows)[:, None]
    if dev.type == "cpu":
        return _spmm_plain(indptr, indices, data, b, n_rows)
    c = torch.empty((n_rows, k), dtype=b.dtype, device=dev)
    if n_rows and k:
        # one chunk warp (and partial) per SPMM_SEG physical entries: a
        # host-known bound on the logical entries' chunks, so no sync
        n_chunks = indices.numel() // SPMM_SEG + 1
        part = torch.empty((n_chunks, k), dtype=b.dtype, device=dev)
        kernels.launch("csr_spmm", dev, _DTYPE_CODE[b.dtype],
                       int(indptr.dtype == torch.int64), indptr.data_ptr(),
                       indices.data_ptr(), data.data_ptr(), b.data_ptr(),
                       b.stride(0), c.data_ptr(), c.stride(0), n_rows, k,
                       n_chunks, SPMM_SEG, part.data_ptr())
    return c


def _operands(fmt: GridSpMV, v: torch.Tensor):
    """The plan's data and ``v`` in the working type: f64 when either is
    f64, else f32."""
    dtype = (torch.float64 if torch.float64 in (fmt.data.dtype, v.dtype)
             else torch.float32)
    return fmt.data.to(dtype), v.to(dtype)


def spmv(fmt: GridSpMV, x) -> torch.Tensor:
    """y = A·x on the prepared plan. A non-tensor x goes to the handle's
    device (``cuda:0``)."""
    x = as_tensor(x)
    if tuple(x.shape) != (fmt.n_cols,):
        raise ValueError(f"x must be ({fmt.n_cols},), got {tuple(x.shape)}")
    data, x = _operands(fmt, x)
    owners = fmt.spmv_owners() if x.device.type == "cuda" else None
    return _spmv(fmt.indptr, fmt.indices, data, x, fmt.n_rows, owners)


def spmm(fmt: GridSpMV, b) -> torch.Tensor:
    """C = A·B for dense B (n_cols, k); k == 1 runs the SpMV kernel, as in
    the reference."""
    b = as_tensor(b)
    if b.dim() != 2 or b.shape[0] != fmt.n_cols:
        raise ValueError(f"b must be ({fmt.n_cols}, k), got "
                         f"{tuple(b.shape)}")
    data, b = _operands(fmt, b)
    return _spmm(fmt.indptr, fmt.indices, data, b, fmt.n_rows)
