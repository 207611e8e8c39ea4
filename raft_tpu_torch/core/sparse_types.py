"""CSR and COO matrices over torch tensors (counterpart of
``raft_tpu/core/sparse_types.py``).

The padding contract is the reference package's, unchanged, so both
packages build the same structure from the same scipy matrix:

- ``indices``/``data`` may be padded up to an nnz size class
  (:func:`nnz_bucket`); pad entries carry column 0 and data 0;
- ``indptr`` is never touched, so ``indptr[-1]`` stays the LOGICAL nnz
  and :attr:`CSRMatrix.nnz` is the PHYSICAL one;
- :meth:`CSRMatrix.from_scipy` pads by default (``RAFT_TPU_SPARSE_PAD``,
  on unless set to 0/false).

The reference pads so that nearby nnz share one jit executable; PyTorch
runs eagerly and the CUDA kernels read each row by ``indptr``, so here
the padding is only a contract to keep, never read.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import env
from raft_tpu_torch.core.resources import as_tensor, default_resources

__all__ = ["PAD_MIN_NNZ", "nnz_bucket", "CSRMatrix", "COOMatrix"]

PAD_MIN_NNZ = 256


def nnz_bucket(n: int, min_size: int = PAD_MIN_NNZ) -> int:
    """Smallest quarter-octave size class (2^k x {1, 1.25, 1.5, 1.75})
    >= n."""
    if n <= min_size:
        return min_size
    b = min_size
    while b * 2 <= n:
        b *= 2
    for frac in (4, 5, 6, 7):
        cand = b * frac // 4
        if cand >= n:
            return cand
    return b * 2


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class CSRMatrix:
    """Compressed sparse row matrix: ``indptr [n_rows + 1]``, ``indices
    [nnz]`` (int32), ``data [nnz]``."""

    def __init__(self, indptr, indices, data, shape: Tuple[int, int]):
        self.indptr = indptr
        self.indices = indices
        self.data = data
        self.shape = (int(shape[0]), int(shape[1]))

    @property
    def nnz(self) -> int:
        """PHYSICAL nnz; with padding it exceeds :meth:`logical_nnz`."""
        return int(self.indices.shape[0])

    def logical_nnz(self) -> int:
        """The stored-entry count ``indptr[-1]``, as a host int (cached
        where known at construction)."""
        hint = getattr(self, "_logical_nnz_hint", None)
        if hint is None:
            hint = int(self.indptr[-1])
            self._logical_nnz_hint = hint
        return hint

    def pad_nnz(self, target: Optional[int] = None,
                min_size: int = PAD_MIN_NNZ) -> "CSRMatrix":
        """Pad indices/data to ``target`` (default: the nnz size class)
        with column-0, data-0 entries; ``indptr`` is unchanged."""
        phys = self.nnz
        logical = self.logical_nnz()
        if target is None:
            target = nnz_bucket(max(logical, phys), min_size)
        pad = target - phys
        if pad <= 0:
            return self
        out = CSRMatrix(
            self.indptr,
            torch.cat([self.indices, self.indices.new_zeros(pad)]),
            torch.cat([self.data, self.data.new_zeros(pad)]), self.shape)
        out._logical_nnz_hint = logical
        return out

    def depad(self) -> "CSRMatrix":
        """Slice back to the logical nnz."""
        n = self.logical_nnz()
        if n == self.nnz:
            return self
        return CSRMatrix(self.indptr, self.indices[:n], self.data[:n],
                         self.shape)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def structure_view(self):
        return self.indptr, self.indices

    def _moved(self, device) -> "CSRMatrix":
        out = CSRMatrix(self.indptr.to(device), self.indices.to(device),
                        self.data.to(device), self.shape)
        hint = getattr(self, "_logical_nnz_hint", None)
        if hint is not None:
            out._logical_nnz_hint = hint
        return out

    def to_device(self, res=None) -> "CSRMatrix":
        """The same matrix on the handle's device (``cuda:0`` by
        default)."""
        return self._moved(default_resources(res).device)

    def to_host(self) -> "CSRMatrix":
        """The same matrix in CPU tensors."""
        return self._moved("cpu")

    def to_scipy(self):
        import scipy.sparse as sp

        h = self.depad()
        return sp.csr_matrix((_host(h.data), _host(h.indices),
                              _host(h.indptr)), shape=self.shape)

    @staticmethod
    def from_scipy(mat, pad: Optional[bool] = None,
                   res=None) -> "CSRMatrix":
        """scipy -> CSR on the handle's device (``cuda:0`` by default).
        ``pad`` controls the nnz bucketing (default on; off per call with
        ``pad=False`` or globally with ``RAFT_TPU_SPARSE_PAD=0``). The
        arrays keep scipy's dtypes."""
        mat = mat.tocsr()
        out = CSRMatrix(as_tensor(np.array(mat.indptr), res),
                        as_tensor(np.array(mat.indices), res),
                        as_tensor(np.array(mat.data), res), mat.shape)
        out._logical_nnz_hint = int(mat.nnz)
        if pad if pad is not None else env.read("RAFT_TPU_SPARSE_PAD"):
            out = out.pad_nnz()
        return out

    def host_edges(self):
        """Host numpy ``(rows, cols, data)`` of the LOGICAL entries."""
        n = self.logical_nnz()
        lengths = np.diff(_host(self.indptr))
        rows = np.repeat(np.arange(self.n_rows, dtype=np.int32),
                         lengths).astype(np.int32)[:n]
        cols = _host(self.indices)[:n].astype(np.int32)
        return rows, cols, _host(self.data)[:n]

    def row_lengths(self):
        return self.indptr[1:] - self.indptr[:-1]

    def row_ids(self):
        """Per-entry row ids, PHYSICAL length: pad slots get the last
        row's id, as in the reference."""
        row_range = torch.arange(self.n_rows, dtype=self.indices.dtype,
                                 device=self.indices.device)
        out = torch.repeat_interleave(row_range, self.row_lengths().long(),
                                      output_size=self.logical_nnz())
        if out.shape[0] < self.nnz:
            fill = self.n_rows - 1 if self.n_rows else 0
            out = torch.cat([out, out.new_full((self.nnz - out.shape[0],),
                                               fill)])
        return out


class COOMatrix:
    """Coordinate-format matrix: ``rows [nnz]``, ``cols [nnz]``,
    ``data [nnz]``."""

    def __init__(self, rows, cols, data, shape: Tuple[int, int]):
        self.rows = rows
        self.cols = cols
        self.data = data
        self.shape = (int(shape[0]), int(shape[1]))

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    def _moved(self, device) -> "COOMatrix":
        return COOMatrix(self.rows.to(device), self.cols.to(device),
                         self.data.to(device), self.shape)

    def to_device(self, res=None) -> "COOMatrix":
        return self._moved(default_resources(res).device)

    def to_host(self) -> "COOMatrix":
        return self._moved("cpu")

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.coo_matrix((_host(self.data), (_host(self.rows),
                                                 _host(self.cols))),
                             shape=self.shape)

    @staticmethod
    def from_scipy(mat, res=None) -> "COOMatrix":
        """scipy -> COO on the handle's device (``cuda:0`` by default)."""
        mat = mat.tocoo()
        return COOMatrix(as_tensor(np.array(mat.row), res),
                         as_tensor(np.array(mat.col), res),
                         as_tensor(np.array(mat.data), res), mat.shape)
