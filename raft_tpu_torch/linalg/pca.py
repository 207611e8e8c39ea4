"""PCA and truncated SVD (counterpart of ``raft_tpu/linalg/pca.py``).

The solvers keep the reference's names (``Solver``): the covariance's
eigendecomposition (``cal_eig``, ``torch.linalg.eigh``; it takes every
solver name, as the reference's), or the randomized SVD. Components are
rows, sign-flipped so each one's largest-magnitude entry is positive.

Incremental PCA (``pca_partial_fit``, ``pca_finalize``) absorbs a batch
``chunk_rows`` rows at a time by Chan's parallel mean and scatter
merge, each chunk centered about its own mean, in a host loop of device
work (the reference runs its chunks through its compiled-driver chunk
runner). The tail chunk takes its valid rows only, which is the
reference's zero weight for its pad rows. Checkpoints (``core.checkpoint``,
prefix ``pca_pf``) hold ``mean``, ``scatter``, ``count`` and the chunk
cursor ``chunk`` at the reference's boundaries, and ``resume_from``
continues the SAME batch from the saved cursor, bit for bit the run it
was cut from. ``sync_every > 1`` (chunks as one device program) is not
ported yet: it becomes a CUDA-graph capture with ROADMAP.md, queue A
item 13b, and raises ``NotImplementedError``.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import numpy as np
import torch

from raft_tpu_torch.core import trace
from raft_tpu_torch.core.operators import exact_sqrt
from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.random.rng_state import RngState
from raft_tpu_torch.util.input_validation import (expect_2d, expect_finite,
                                                  expect_one_sync,
                                                  expect_positive)
from raft_tpu_torch.util.precision import with_matmul_precision


class Solver(enum.Enum):
    COV_EIG_DQ = "cov_eig_dq"
    COV_EIG_JACOBI = "cov_eig_jacobi"
    RANDOMIZED = "randomized"


class PCAResult(NamedTuple):
    components: torch.Tensor          # [n_components, n_cols]
    explained_variance: torch.Tensor  # [n_components]
    explained_variance_ratio: torch.Tensor
    singular_values: torch.Tensor
    mean: torch.Tensor                # [n_cols]
    noise_variance: torch.Tensor      # scalar


def sign_flip_components(components, U=None):
    """The max-|value| entry of each component (the first of equal ones)
    made positive; ``U``'s columns flipped alike."""
    comps = as_tensor(components)
    idx = torch.argmax(torch.abs(comps), dim=1)
    signs = torch.sign(comps[torch.arange(comps.shape[0],
                                          device=comps.device), idx])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    comps = comps * signs[:, None]
    if U is not None:
        return comps, as_tensor(U).to(comps.device) * signs[None, :]
    return comps


def cal_eig(res, cov, n_components: int, solver: Solver = Solver.COV_EIG_DQ):
    """Top ``n_components`` eigenpairs of a covariance matrix, eigenvalues
    descending."""
    w, v = torch.linalg.eigh(as_tensor(cov, res))
    w = torch.flip(w, (0,))
    v = torch.flip(v, (1,))
    return w[:n_components], v[:, :n_components]


def _total_var(X):
    return torch.sum(torch.var(X, dim=0, correction=1))


@with_matmul_precision
def pca_fit(res, X, n_components: int,
            solver: Solver = Solver.COV_EIG_DQ,
            state: Optional[RngState] = None) -> PCAResult:
    """Fit PCA: components as rows, the explained variance (n - 1
    divisor), its ratio, the singular values, the column mean and the
    noise variance."""
    X = as_tensor(X, res)
    expect_2d(X, name="pca_fit: X")
    expect_positive(n_components, name="pca_fit: n_components")
    expect_finite(X, name="pca_fit: X")
    n_rows, n_cols = X.shape
    mu = torch.mean(X, dim=0)
    Xc = X - mu[None, :]
    if solver == Solver.RANDOMIZED:
        from raft_tpu_torch.linalg.svd import rsvd_fixed_rank

        u, s, v = rsvd_fixed_rank(res, Xc, n_components, state=state)
        explained = (s * s) / (n_rows - 1)
        comps = v.T
    else:
        cov = (Xc.T @ Xc) / (n_rows - 1)
        w, v = cal_eig(res, cov, n_components, solver)
        explained = w
        s = exact_sqrt(torch.clamp_min(w * (n_rows - 1), 0.0))
        comps = v.T
    comps = sign_flip_components(comps)
    total_var = _total_var(X)
    ratio = explained / total_var
    if n_components < min(n_rows, n_cols):
        noise = (total_var - torch.sum(explained)) / (
            min(n_rows, n_cols) - n_components)
    else:
        noise = torch.zeros((), dtype=X.dtype, device=X.device)
    dt = X.dtype
    return PCAResult(comps.to(dt), explained.to(dt), ratio.to(dt),
                     s.to(dt), mu, noise.to(dt))


@with_matmul_precision
def pca_transform(res, X, result: PCAResult, whiten: bool = False):
    """Project into component space."""
    X = as_tensor(X, res)
    t = (X - result.mean[None, :]) @ result.components.T
    if whiten:
        t = t / exact_sqrt(torch.clamp_min(result.explained_variance,
                                           1e-30))[None, :]
    return t


@with_matmul_precision
def pca_inverse_transform(res, T, result: PCAResult, whiten: bool = False):
    T = as_tensor(T, res)
    if whiten:
        T = T * exact_sqrt(torch.clamp_min(result.explained_variance,
                                           1e-30))[None, :]
    return T @ result.components + result.mean[None, :]


@with_matmul_precision
def pca_fit_transform(res, X, n_components: int, **kw):
    result = pca_fit(res, X, n_components, **kw)
    return pca_transform(res, X, result), result


# -- incremental PCA ---------------------------------------------------------


class IncrementalPCAState(NamedTuple):
    """Sufficient statistics of streaming PCA: the running column mean,
    the centered scatter ``S = Σ (x−μ)(x−μ)ᵀ`` and the row count, f32.
    Thread it through :func:`pca_partial_fit` calls, then
    :func:`pca_finalize` turns it into a :class:`PCAResult`."""

    mean: torch.Tensor     # [n_cols] float32
    scatter: torch.Tensor  # [n_cols, n_cols] float32
    count: torch.Tensor    # scalar float32


def _merge_chunk(mean, S, count, rows):
    """Chan's update of (mean, S, count) by the rows of one chunk,
    centered about their own mean."""
    nb = float(rows.shape[0])
    mean_b = torch.sum(rows, dim=0) / nb
    centered = rows - mean_b[None, :]
    new_count = count + nb
    delta = mean_b - mean
    new_mean = mean + delta * (nb / new_count)
    new_S = S + centered.T @ centered + (count * nb / new_count) * torch.outer(
        delta, delta)
    return new_mean, new_S, new_count


@with_matmul_precision
def pca_partial_fit(res, batch, *, state: Optional[
        IncrementalPCAState] = None, chunk_rows: int = 256,
        sync_every=None, checkpoint_dir: Optional[str] = None,
        checkpoint_every: Optional[int] = None, checkpoint_keep: int = 2,
        resume_from: Optional[str] = None) -> IncrementalPCAState:
    """Absorb one batch into the streaming PCA statistics and return the
    updated :class:`IncrementalPCAState` (``state=None`` starts cold).

    ``checkpoint_every`` (in chunks; needs ``checkpoint_dir``) saves
    ``(mean, scatter, count, chunk)`` at chunk boundaries, and
    ``resume_from`` (a checkpoint file, or a directory whose newest wins)
    restarts mid-batch from the saved chunk cursor: the SAME ``batch``
    must be passed again, since the cursor indexes into it."""
    from raft_tpu_torch.runtime import limits

    batch = as_tensor(batch, res)
    expect_2d(batch, name="pca_partial_fit: batch")
    if batch.shape[0] < 1:
        raise ValueError("batch must have at least one row")
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    expect_one_sync(sync_every, "pca_partial_fit")
    d = int(batch.shape[1])
    dev = batch.device
    f32 = torch.float32
    if state is None:
        state = IncrementalPCAState(
            torch.zeros((d,), dtype=f32, device=dev),
            torch.zeros((d, d), dtype=f32, device=dev),
            torch.zeros((), dtype=f32, device=dev))
    elif state.mean.shape != (d,) or state.scatter.shape != (d, d):
        raise ValueError(
            f"state was fit on {state.mean.shape[0]} columns, "
            f"batch has {d}")
    n = int(batch.shape[0])
    chunk_rows = min(int(chunk_rows), n)
    n_chunks = -(-n // chunk_rows)
    x = batch.to(f32)

    manager = None
    if checkpoint_every is not None:
        if checkpoint_dir is None:
            raise ValueError("checkpoint_every requires checkpoint_dir")
        from raft_tpu_torch.core import checkpoint as core_ckpt

        manager = core_ckpt.CheckpointManager(
            checkpoint_dir, prefix="pca_pf", keep=checkpoint_keep)
    start_chunk = 0
    mean, S, count = (torch.as_tensor(t, device=dev).to(f32)
                      for t in state)
    if resume_from is not None:
        from raft_tpu_torch.cluster.kmeans import _load_kmeans_checkpoint

        entries = _load_kmeans_checkpoint(resume_from, prefix="pca_pf")
        mean, S, count = (torch.as_tensor(np.asarray(entries[key]),
                                          device=dev).to(f32)
                          for key in ("mean", "scatter", "count"))
        start_chunk = int(entries["chunk"])
        if start_chunk > n_chunks:
            raise ValueError(
                f"resume_from chunk {start_chunk} beyond this batch's "
                f"{n_chunks} chunks — pass the SAME batch the "
                "checkpoint was cut from")

    stride = None if manager is None else max(1, int(checkpoint_every))
    last_saved = start_chunk if resume_from is not None else -1
    done = False
    steps = start_chunk
    while True:
        # the reference's boundary: checkpoint, then the deadline poll
        if manager is not None and steps > 0 and (
                steps - max(last_saved, 0) >= stride
                or ((done or steps >= n_chunks) and steps != last_saved)):
            manager.save(steps, {
                "mean": mean.cpu().numpy(), "scatter": S.cpu().numpy(),
                "count": count.cpu().numpy(), "chunk": int(steps)})
            last_saved = steps
        limits.check_deadline("linalg.pca_partial_fit")
        if done or steps >= n_chunks:
            break
        mean, S, count = _merge_chunk(
            mean, S, count, x[steps * chunk_rows:(steps + 1) * chunk_rows])
        steps += 1
        done = steps >= n_chunks
    trace.record_event("pca.partial_fit", rows=n, n_cols=d,
                       chunks=int(steps), chunk_rows=chunk_rows)
    return IncrementalPCAState(mean, S, count)


def pca_finalize(res, state: IncrementalPCAState, n_components: int,
                 solver: Solver = Solver.COV_EIG_DQ) -> PCAResult:
    """Eigendecompose the accumulated statistics into the
    :class:`PCAResult` a monolithic :func:`pca_fit` on the same rows
    gives."""
    expect_positive(n_components, name="pca_finalize: n_components")
    n_rows = int(state.count)
    if n_rows < 2:
        raise ValueError(
            f"pca_finalize needs >= 2 absorbed rows, got {n_rows}")
    d = int(state.mean.shape[0])
    scatter = as_tensor(state.scatter, res)
    cov = scatter / (n_rows - 1)
    w, v = cal_eig(res, cov, n_components, solver)
    explained = w
    s = exact_sqrt(torch.clamp_min(w * (n_rows - 1), 0.0))
    comps = sign_flip_components(v.T)
    total_var = torch.trace(scatter) / (n_rows - 1)
    ratio = explained / total_var
    if n_components < min(n_rows, d):
        noise = (total_var - torch.sum(explained)) / (
            min(n_rows, d) - n_components)
    else:
        noise = torch.zeros((), dtype=torch.float32, device=scatter.device)
    f32 = torch.float32
    return PCAResult(comps.to(f32), explained.to(f32), ratio.to(f32),
                     s.to(f32), as_tensor(state.mean, res),
                     noise.to(f32))


# -- truncated SVD (no centering) --------------------------------------------


class TSVDResult(NamedTuple):
    components: torch.Tensor
    singular_values: torch.Tensor
    explained_variance: torch.Tensor
    explained_variance_ratio: torch.Tensor


@with_matmul_precision
def tsvd_fit(res, X, n_components: int,
             solver: Solver = Solver.COV_EIG_DQ,
             state: Optional[RngState] = None) -> TSVDResult:
    """Truncated SVD of the *uncentered* data (eig of XᵀX, or the
    randomized SVD)."""
    X = as_tensor(X, res)
    if solver == Solver.RANDOMIZED:
        from raft_tpu_torch.linalg.svd import rsvd_fixed_rank

        u, s, v = rsvd_fixed_rank(res, X, n_components, state=state)
        comps = v.T
    else:
        w, v = cal_eig(res, X.T @ X, n_components, solver)
        s = exact_sqrt(torch.clamp_min(w, 0.0))
        comps = v.T
    comps = sign_flip_components(comps)
    explained = torch.var(X @ comps.T, dim=0, correction=1)
    total_var = _total_var(X)
    dt = X.dtype
    return TSVDResult(comps.to(dt), s.to(dt), explained.to(dt),
                      (explained / total_var).to(dt))


@with_matmul_precision
def tsvd_transform(res, X, result: TSVDResult):
    return as_tensor(X, res) @ result.components.T


@with_matmul_precision
def tsvd_inverse_transform(res, T, result: TSVDResult):
    return as_tensor(T, res) @ result.components


@with_matmul_precision
def tsvd_fit_transform(res, X, n_components: int, **kw):
    result = tsvd_fit(res, X, n_components, **kw)
    return tsvd_transform(res, X, result), result
