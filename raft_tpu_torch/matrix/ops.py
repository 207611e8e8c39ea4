"""Dense matrix utilities (counterpart of ``raft_tpu/matrix/ops.py``):
copies, diagonals, fills, norms, elementwise maps, reversal, sign flip,
slices, triangles, shifts, the per-row sort and row sampling, as torch
ops on the input's device (an array goes to the handle's, ``cuda:0`` by
default). Functions that build a matrix from nothing (``eye``, ``fill``,
``linspace``) make it on the handle's device.

``sort_cols_per_row`` sorts ``-m`` for the descending order, as the
reference does, so NaN, -0.0 and an integer minimum land where they land
there: a stable sort keeps -0.0 and +0.0 in input order, puts NaN last
(first after the negation back) and leaves ``-INT_MIN`` wrapped.
``sample_rows`` draws through :func:`raft_tpu_torch.random.rng.
excess_subsample` (its top-k by ``matrix.select_k``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import resources
from raft_tpu_torch.random.rng_state import RngState


def _m(res, matrix) -> torch.Tensor:
    return resources.as_tensor(matrix, res)


def _dev(res) -> torch.device:
    return resources.default_resources(res).device


def _sqrt(m: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root. On the CPU, 16- and 32-bit floats
    go through f64, whose rounding back is exact for a square root
    (torch's f32 CPU kernel is not correctly rounded); the card's
    ``sqrtf``, like ``jnp.sqrt``, already is."""
    if (m.device.type == "cpu" and m.is_floating_point()
            and m.dtype != torch.float64):
        return torch.sqrt(m.to(torch.float64)).to(m.dtype)
    return torch.sqrt(m)


def copy(res, matrix):
    """A fresh copy."""
    return _m(res, matrix).clone()


def get_diagonal(res, matrix):
    """The main diagonal, as a fresh vector."""
    return torch.diagonal(_m(res, matrix)).clone()


def set_diagonal(res, matrix, vec):
    """A copy whose first ``min(shape)`` diagonal entries are ``vec``'s."""
    m = _m(res, matrix).clone()
    n = min(m.shape)
    idx = torch.arange(n, device=m.device)
    m[idx, idx] = torch.as_tensor(vec, device=m.device).to(m.dtype)[:n]
    return m


def invert_diagonal(res, matrix):
    """A copy with each diagonal entry replaced by its reciprocal."""
    m = _m(res, matrix).clone()
    n = min(m.shape)
    idx = torch.arange(n, device=m.device)
    m[idx, idx] = 1.0 / m[idx, idx]
    return m


def eye(res, n_rows: int, n_cols: Optional[int] = None,
        dtype=torch.float32):
    """Identity fill, on the handle's device."""
    return torch.eye(n_rows, n_rows if n_cols is None else n_cols,
                     dtype=dtype, device=_dev(res))


def fill(res, shape, value, dtype=torch.float32):
    """Constant fill, on the handle's device."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return torch.full(shape, value, dtype=dtype, device=_dev(res))


def linspace(res, start, stop, n: int, dtype=torch.float32):
    """``n`` points from ``start`` to ``stop`` inclusive, in the
    reference's arithmetic: ``start·(1 - t) + stop·t`` with ``t = i /
    (n - 1)`` in ``dtype``, the last point ``stop`` itself."""
    dev = _dev(res)
    if n <= 1:
        return torch.full((n,), start, dtype=dtype, device=dev)
    div = n - 1
    t = torch.arange(div, dtype=dtype, device=dev) / torch.tensor(
        div, dtype=dtype, device=dev)
    a = torch.tensor(start, dtype=dtype, device=dev)
    b = torch.tensor(stop, dtype=dtype, device=dev)
    return torch.cat([a * (1 - t) + b * t, b[None]])


def l2_norm(res, matrix):
    """Frobenius norm."""
    m = _m(res, matrix)
    return _sqrt(torch.sum(m * m))


def weighted_power(res, matrix, weight: float = 1.0, exponent: float = 2.0):
    """``weight · m^exponent`` elementwise."""
    return weight * torch.pow(_m(res, matrix), exponent)


def power(res, matrix, exponent: float = 2.0):
    return torch.pow(_m(res, matrix), exponent)


def ratio(res, matrix):
    """``m / sum(m)``."""
    m = _m(res, matrix)
    return m / torch.sum(m)


def reciprocal(res, matrix, scalar: float = 1.0, setzero: bool = False,
               thres: float = 1e-15):
    """``scalar / m``; with ``setzero``, 0 where ``|m| <= thres``."""
    m = _m(res, matrix)
    if setzero:
        return torch.where(m.abs() <= thres, torch.zeros_like(m), scalar / m)
    return scalar / m


def col_reverse(res, matrix):
    """Columns in reverse order."""
    return torch.flip(_m(res, matrix), (1,))


def row_reverse(res, matrix):
    """Rows in reverse order."""
    return torch.flip(_m(res, matrix), (0,))


def sign_flip(res, matrix):
    """Each column times the sign of its largest-magnitude entry (the
    first on ties, a NaN largest), 0 counting as +1 and a NaN sign
    making the column NaN, as ``jnp.sign``."""
    from raft_tpu_torch.matrix.epilogue import argmax

    m = _m(res, matrix)
    idx = argmax(res, m.abs().T).long()
    top = m[idx, torch.arange(m.shape[1], device=m.device)]
    signs = torch.where(torch.isnan(top), top, torch.sign(top))
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return m * signs[None, :]


def slice(res, matrix, row_range: Tuple[int, int],
          col_range: Tuple[int, int]):
    """The submatrix ``[row_range) x [col_range)``, copied."""
    m = _m(res, matrix)
    return m[row_range[0]:row_range[1], col_range[0]:col_range[1]].clone()


def sqrt(res, matrix):
    return _sqrt(_m(res, matrix))


def zero_small_values(res, matrix, thres: float = 1e-15):
    """0 where ``|m| < thres``."""
    m = _m(res, matrix)
    return torch.where(m.abs() < thres, torch.zeros_like(m), m)


def upper_triangular(res, matrix):
    return torch.triu(_m(res, matrix))


def lower_triangular(res, matrix):
    return torch.tril(_m(res, matrix))


# -- shift -------------------------------------------------------------------

SHIFT_TOWARDS_END = "towards_end"
SHIFT_TOWARDS_BEGINNING = "towards_beginning"


def _fill_block(m, shape, fill_value, values):
    if values is not None:
        return torch.broadcast_to(
            torch.as_tensor(values, device=m.device).to(m.dtype), shape)
    return torch.full(shape, fill_value, dtype=m.dtype, device=m.device)


def col_shift(res, matrix, k: int = 1,
              direction: str = SHIFT_TOWARDS_END, fill_value=0.0,
              values=None):
    """Columns shifted by ``k``; the vacated columns hold ``fill_value``
    or ``values`` (broadcast to [n_rows, k])."""
    m = _m(res, matrix)
    n_rows, n_cols = m.shape
    block = _fill_block(m, (n_rows, k), fill_value, values)
    if direction == SHIFT_TOWARDS_END:
        return torch.cat([block, m[:, :n_cols - k]], dim=1)
    return torch.cat([m[:, k:], block], dim=1)


def row_shift(res, matrix, k: int = 1,
              direction: str = SHIFT_TOWARDS_END, fill_value=0.0,
              values=None):
    """Rows shifted by ``k``; the vacated rows hold ``fill_value`` or
    ``values`` (broadcast to [k, n_cols])."""
    m = _m(res, matrix)
    n_rows, n_cols = m.shape
    block = _fill_block(m, (k, n_cols), fill_value, values)
    if direction == SHIFT_TOWARDS_END:
        return torch.cat([block, m[:n_rows - k, :]], dim=0)
    return torch.cat([m[k:, :], block], dim=0)


# -- per-row sort -------------------------------------------------------------

def sort_cols_per_row(res, matrix, ascending: bool = True,
                      return_indices: bool = False):
    """Each row's values sorted (a stable sort of ``m``, or of ``-m``
    negated back for the descending order); with ``return_indices``,
    ``(values, int32 source columns)`` of the stable argsort."""
    m = _m(res, matrix)
    order = m if ascending else -m
    if return_indices:
        idx = torch.argsort(order, dim=1, stable=True)
        return torch.gather(m, 1, idx), idx.to(torch.int32)
    srt = torch.sort(order, dim=1, stable=True).values
    return srt if ascending else -srt


# -- sample_rows -------------------------------------------------------------

def sample_rows(res, state: RngState, matrix, n_samples: int):
    """``n_samples`` rows drawn uniformly without replacement by
    ``random.excess_subsample`` (on the handle's device), in the
    sample's order."""
    from raft_tpu_torch.random.rng import excess_subsample

    m = _m(res, matrix)
    idx = excess_subsample(res, state, n_samples, m.shape[0],
                           dtype=torch.int64)
    return m[idx.to(m.device)]


def print_matrix(res, matrix, name: str = "", h_separator: str = " ",
                 v_separator: str = "\n") -> str:
    """Render on the host in the reference's format (``%g`` entries,
    ``name`` then ``v_separator`` first when given), print it and return
    it."""
    import numpy as np

    m = matrix.detach().cpu().numpy() if isinstance(matrix, torch.Tensor) \
        else np.asarray(matrix)
    body = v_separator.join(
        h_separator.join(f"{v:g}" for v in row) for row in np.atleast_2d(m))
    out = (name + v_separator if name else "") + body
    print(out)
    return out
