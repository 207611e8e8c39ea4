"""k-means (Lloyd) on one device over the fused contraction kernels
(counterpart of the single-device half of ``raft_tpu/cluster/kmeans.py``).

- Each Lloyd iteration is one fused pass (``csrc/fused_lloyd.cu``):
  distances, first-min labels, and the per-centroid sums and counts,
  accumulated in a fixed order so a fit is bitwise reproducible.
- At tier ``'high'`` X's bf16 halves and norms are hoisted out of the
  loop once per fit (:func:`~raft_tpu_torch.linalg.contractions.lloyd_prepare`).
- Assignment (final labels, ``kmeans_predict``, k-means|| candidate
  weights) is the fused argmin (``csrc/fused_argmin.cu``); the
  distance embedding (``kmeans_transform``) is the pairwise tile
  (``csrc/pairwise_tile.cu``).

The fit is a host loop that tests convergence at the same points as the
reference package, so ``n_iter`` matches it for the same parameters.

Multi-rank, one process a rank over ``raft_tpu_torch.comms``:
:func:`mnmg_lloyd_step` is one Lloyd iteration on a rank's rows, and
:func:`kmeans_fit_mnmg` the fit around it (BASELINE config 5), with its
checkpoints (``core.checkpoint``), resume and recovery from a peer's
failure. :func:`kmeans_fit_elastic` is the host (numpy f64) fit over a
host-only clique that outlives a killed process.

``kmeans_fit(sync_every > 1)`` runs chunks of Lloyd iterations through
:mod:`raft_tpu_torch.runtime.compiled_driver`: on the card a fit's first
chunk launches its steps one by one and its later chunks replay a
captured CUDA graph of the step and its convergence test, and the host
reads the device once a chunk; the default on the card is 8–16
(``compiled_driver.default_sync_every`` from the step's estimate), on
the CPU 1 (the host loop).
:func:`kmeans_partial_fit` is the minibatch (Sculley) pass through the
same driver, a ``chunk_rows`` slice a step. ``kmeans_fit_mnmg`` stays
host-driven: its chunks are ROADMAP queue A item 13b.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import hw, trace
from raft_tpu_torch.core.guards import ConvergenceError, ConvergenceReport
from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.distance.pairwise import DistanceType, pairwise_distance
from raft_tpu_torch.linalg.contractions import (fused_l2_argmin_pallas,
                                                fused_lloyd_pallas,
                                                fused_lloyd_prepared,
                                                lloyd_prepare)
from raft_tpu_torch.linalg.reduce import _sums_by_key
from raft_tpu_torch.matrix.epilogue import label_onehot
from raft_tpu_torch.random.rng_state import RngState
from raft_tpu_torch.runtime import compiled_driver, limits
from raft_tpu_torch.util.input_validation import (expect_2d,
                                                  expect_finite,
                                                  expect_one_sync)
from raft_tpu_torch.util.precision import with_matmul_precision


class KMeansInit(enum.Enum):
    """Initialization methods, with the reference package's values."""

    KMEANS_PLUS_PLUS = "kmeans++"
    RANDOM = "random"
    ARRAY = "array"  # caller-supplied centroids


@dataclasses.dataclass
class KMeansParams:
    """Hyper-parameters, as in the reference package. ``check_every``:
    convergence is polled every this many iterations (each poll is a
    device-to-host copy of the inertia)."""

    n_clusters: int = 8
    max_iter: int = 300
    tol: float = 1e-4
    init: KMeansInit = KMeansInit.KMEANS_PLUS_PLUS
    oversampling_factor: float = 2.0
    seed: int = 0
    check_every: int = 1


def _as_data(x, res) -> torch.Tensor:
    """:func:`~raft_tpu_torch.core.resources.as_tensor`, as f32."""
    x = as_tensor(x, res)
    if not x.is_floating_point():
        raise TypeError(f"expected floating data, got {x.dtype}")
    return x.to(torch.float32).contiguous()


def _assign(x, centroids):
    """Nearest-centroid ``(dist², labels)`` through the fused argmin."""
    return fused_l2_argmin_pallas(x, centroids)


def _finish_update(sums, counts, old_centroids):
    """sums/counts -> new centroids; an empty cluster keeps its centroid.
    Counts may be fractional under sample weights: divide by the actual
    positive mass."""
    safe = torch.where(counts > 0, counts, torch.ones_like(counts))[:, None]
    new = (sums / safe).to(old_centroids.dtype)
    return torch.where(counts[:, None] > 0, new, old_centroids)


@with_matmul_precision
def lloyd_step(x, centroids, n_clusters: int):
    """One Lloyd iteration: ``(new_centroids, inertia, labels)``, with
    inertia and labels measured against the input centroids."""
    sums, counts, dist, labels = fused_lloyd_pallas(x, centroids)
    return _finish_update(sums, counts, centroids), torch.sum(dist), labels


@with_matmul_precision
def lloyd_step_prepared(ops, centroids, *, m: int):
    """:func:`lloyd_step` against the operands of ``lloyd_prepare``;
    bitwise the same result."""
    sums, counts, dist, labels = fused_lloyd_prepared(ops, centroids, m=m)
    return _finish_update(sums, counts, centroids), torch.sum(dist), labels


@with_matmul_precision
def lloyd_iterate_prepared(ops, centroids, n_steps: int, *, m: int):
    """``n_steps`` prepared Lloyd iterations back to back; returns the
    last step's ``(centroids, inertia, labels)``."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    c = centroids
    for _ in range(n_steps):
        c, inertia, labels = lloyd_step_prepared(ops, c, m=m)
    return c, inertia, labels


def _weighted_sums(x, w, labels, dist, n_clusters: int):
    """Weighted ``(sums, counts, inertia term)`` from an assignment. The
    one-hot product stays a matmul, as the reference package leaves it
    to XLA outside its kernels."""
    wf = w.to(torch.float32)
    oh = label_onehot(labels, n_clusters)
    return oh.T @ (x * wf[:, None]), oh.T @ wf, torch.sum(dist * wf)


@with_matmul_precision
def weighted_lloyd_step(x, w, centroids, n_clusters: int):
    """Sample-weighted Lloyd iteration: fused argmin assignment, weighted
    one-hot update. ``w == 1`` gives :func:`lloyd_step`'s centroids."""
    dist, labels = _assign(x, centroids)
    sums, counts, winertia = _weighted_sums(x, w, labels, dist, n_clusters)
    return _finish_update(sums, counts, centroids), winertia, labels


def _lloyd_convergence_step(step, carry, tol: float):
    """The chunked fit's step: one Lloyd update by ``step(c) -> (c,
    inertia, labels)``, then the host loop's relative-inertia test.
    ``prev`` is +inf until the first completed iteration (the host's
    ``prev is None``); the accumulator dtype is float64, so the test
    matches the host loop's Python-float arithmetic bit for bit."""
    c, prev, _ = carry
    new_c, inertia, _ = step(c)
    cur = inertia.to(prev.dtype)
    rel = torch.abs(prev - cur) / torch.clamp_min(prev, 1e-30)
    finite = torch.isfinite(prev)
    rel = torch.where(finite, rel, float("inf"))
    done = finite & (rel <= tol)
    return (new_c, cur, rel), done


def _validate_sample_weights(w: torch.Tensor, n_rows: int) -> None:
    if tuple(w.shape) != (n_rows,):
        raise ValueError(
            f"sample_weights shape {tuple(w.shape)} != ({n_rows},)")
    if not (bool(torch.isfinite(w).all()) and bool((w >= 0).all())
            and float(w.sum()) > 0):
        raise ValueError("sample_weights must be finite, non-negative, "
                         "with positive total")


def _weighted_plus_plus(rng, cand, w, n_clusters: int):
    """Weighted k-means++ on the small candidate set (host numpy)."""
    ncand = cand.shape[0]
    centers = np.empty((n_clusters, cand.shape[1]), cand.dtype)
    first = rng.choice(ncand, p=w / w.sum())
    centers[0] = cand[first]
    d2 = np.sum((cand - centers[0][None, :]) ** 2, axis=1)
    for i in range(1, n_clusters):
        probs = w * d2
        total = probs.sum()
        if total <= 0:
            nxt = rng.choice(ncand)
        else:
            nxt = rng.choice(ncand, p=probs / total)
        centers[i] = cand[nxt]
        d2 = np.minimum(d2, np.sum((cand - cand[nxt][None, :]) ** 2, axis=1))
    return centers


def _kmeans_plus_plus(gen: torch.Generator, x, n_clusters: int,
                      oversampling_factor: float = 2.0,
                      sample_weights=None):
    """k-means|| seeding (Bahmani et al.): five oversampled D² rounds over
    the data, each a fused argmin pass against the new candidates, then
    weighted k-means++ on the candidate set. Random draws come from
    ``gen`` (on x's device), never from a global RNG."""
    m = x.shape[0]
    dev = x.device
    if sample_weights is None:
        first = int(torch.randint(0, m, (1,), generator=gen, device=dev))
        wts = None
    else:
        wts = sample_weights.to(torch.float32)
        first = int(torch.multinomial(torch.clamp_min(wts, 1e-30), 1,
                                      generator=gen))
    cand = [x[first][None, :].cpu().numpy()]
    d2 = torch.sum((x - x[first][None, :]) ** 2, dim=1)
    ell = max(1.0, oversampling_factor * n_clusters)
    for _ in range(5):
        mass = d2 if wts is None else d2 * wts
        total = float(torch.sum(mass))
        if total <= 0:
            break
        probs = torch.clamp_max(ell * mass / total, 1.0)
        picked = torch.nonzero(
            torch.rand(m, generator=gen, device=dev) < probs)[:, 0]
        if picked.numel() == 0:
            continue
        new_pts = x[picked]
        cand.append(new_pts.cpu().numpy())
        d2 = torch.minimum(d2, fused_l2_argmin_pallas(x, new_pts)[0])
    cand_np = np.concatenate(cand, axis=0)
    seed = int(torch.randint(0, np.iinfo(np.int32).max, (1,),
                             generator=gen, device=dev))
    rng = np.random.default_rng(seed)
    if cand_np.shape[0] <= n_clusters:
        # too few candidates: top up with random rows (weighted, so a
        # zero-weight point never becomes a seed)
        p = None
        if wts is not None:
            p = wts.cpu().numpy().astype(np.float64)
            p = p / p.sum()
        extra = rng.choice(m, n_clusters - cand_np.shape[0] + 1,
                           replace=False, p=p)
        cand_np = np.concatenate(
            [cand_np, x[torch.as_tensor(extra, device=dev)].cpu().numpy()])
    # weight the candidates by the (weighted) mass each one serves
    _, labels = _assign(x, torch.as_tensor(cand_np, device=dev))
    w = np.bincount(
        labels.cpu().numpy(), minlength=cand_np.shape[0],
        weights=None if wts is None else wts.cpu().numpy().astype(np.float64)
    ).astype(np.float64) + 1e-3
    centers = _weighted_plus_plus(rng, cand_np.astype(np.float64), w,
                                  n_clusters)
    return torch.as_tensor(centers, dtype=x.dtype, device=dev)


def _init_centroids(params: KMeansParams, x, centroids,
                    sample_weights=None):
    # explicit centroids always win (warm start), as in the reference
    if centroids is not None:
        return torch.as_tensor(centroids).to(device=x.device,
                                             dtype=x.dtype).clone()
    if params.init == KMeansInit.ARRAY:
        raise ValueError("init=ARRAY requires centroids")
    gen = RngState(seed=params.seed).key(x.device)
    if params.init == KMeansInit.RANDOM:
        idx = torch.randperm(x.shape[0], generator=gen,
                             device=x.device)[:params.n_clusters]
        return x[idx].clone()
    return _kmeans_plus_plus(gen, x, params.n_clusters,
                             params.oversampling_factor,
                             sample_weights=sample_weights)


def _finish_report(converged: bool, n_iter: int, rel_change: float,
                   params: KMeansParams, strict: bool, op: str):
    report = ConvergenceReport(converged=converged, n_iter=int(n_iter),
                               residual=float(rel_change),
                               tol=float(params.tol))
    obs.record_convergence(op, report)
    if not converged:
        if strict:
            raise ConvergenceError(
                f"{op}: inertia change {rel_change:.3e} still above tol "
                f"{params.tol:.3e} after max_iter={params.max_iter} "
                "Lloyd iterations (strict=True)", report=report, op=op)
        warnings.warn(f"{op}: not converged after {n_iter} iterations "
                      f"(relative inertia change {rel_change:.3e} > tol "
                      f"{params.tol:.3e})", RuntimeWarning, stacklevel=3)
    return report


def kmeans_fit(res, params: KMeansParams, x,
               centroids: Optional[torch.Tensor] = None,
               sample_weights=None, strict: bool = False,
               return_report: bool = False,
               sync_every: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Lloyd's algorithm: ``(centroids, inertia, labels, n_iter)``.

    ``x`` as a tensor runs on its device; as an array it goes to the
    handle's device. Convergence: the relative change of the inertia
    between two polls is at most ``tol``. Polls come every
    ``check_every`` iterations, and at ``max_iter``.

    ``sync_every``: with n > 1, chunks of n Lloyd iterations run through
    :func:`~raft_tpu_torch.runtime.compiled_driver.run_chunked` with the
    convergence test in the chunk after every iteration; on the card the
    first chunk launches its steps one by one, later chunks replay a
    captured CUDA graph of the step, and the host reads the device once
    a chunk.
    ``sync_every=1`` is the host loop. The default ``None`` asks the cost
    model with the step's estimated seconds: 1 on the CPU, 8–16 on a
    CUDA card (a step after convergence still launches, masked; its
    Lloyd pass is gated off, so it costs its launches). A weighted fit,
    and a fit whose step is estimated below a launch's host overhead
    (``compiled_driver.DISPATCH_OVERHEAD_S``), default to the host loop
    on the card too: their masked steps would cost what active ones do.
    Captured chunks and the host loop give the same bits.

    ``strict=True`` raises :class:`ConvergenceError` when ``max_iter``
    passes unconverged; ``return_report=True`` appends the
    :class:`ConvergenceReport`. ``sample_weights`` [m] weight the update
    and the inertia."""
    op = "cluster.kmeans_fit"
    x = _as_data(x, res)
    expect_2d(x, name="kmeans_fit: x")
    expect_finite(x, name="kmeans_fit: x")
    w = None
    if sample_weights is not None:
        w = torch.as_tensor(sample_weights, device=x.device)
        _validate_sample_weights(w, x.shape[0])
        w = w.to(torch.float32)
    dims = dict(m=int(x.shape[0]), k=int(x.shape[1]),
                n_clusters=params.n_clusters, itemsize=x.element_size())
    backend = hw.backend_of(x.device)
    est = limits.estimate_seconds("cluster.lloyd_step", backend=backend,
                                  **dims)
    # the host loop by default where chunks gain nothing on the card: a
    # weighted fit (its update is not gated, so a masked step costs a
    # whole step) and a step shorter than a launch's host overhead (its
    # masked steps cost what its active ones do)
    overhead = compiled_driver.DISPATCH_OVERHEAD_S.get(backend, 0.0)
    if sync_every is None and (w is not None or est < overhead):
        sync_every = 1
    sync = compiled_driver.resolve_sync_every(sync_every, step_seconds=est,
                                              device=x.device)
    c = _init_centroids(params, x, centroids, sample_weights=w)
    ops, meta = (None, None) if w is not None \
        else lloyd_prepare(x, params.n_clusters)
    # one Lloyd update, c -> (c, inertia, labels)
    if ops is not None:
        step = functools.partial(lloyd_step_prepared, ops, **meta)
    elif w is not None:
        step = functools.partial(weighted_lloyd_step, x, w,
                                 n_clusters=params.n_clusters)
    else:
        step = functools.partial(lloyd_step, x,
                                 n_clusters=params.n_clusters)
    n_iter = 0
    converged = False
    rel_change = float("inf")
    if sync > 1:
        # chunks of sync iterations, convergence tested in the chunk:
        # the host reads the device once a chunk
        tol = float(params.tol)
        loop = compiled_driver.ChunkLoop(
            lambda cr: _lloyd_convergence_step(step, cr, tol))
        sf, sb = limits.estimate_flops_bytes("cluster.lloyd_step", **dims)
        acc = compiled_driver.host_float_dtype()
        inf = torch.full((), float("inf"), dtype=acc, device=x.device)
        carry = (c, inf, inf.clone())
        carry, n_iter, done = compiled_driver.run_chunked(
            loop, carry, max_steps=params.max_iter,
            sync_every=sync, op=op, est_step_seconds=est, step_flops=sf,
            step_bytes=sb)
        c = carry[0]
        rel_change = float(carry[2])
        converged = bool(done)
    else:
        check = max(1, int(params.check_every))
        prev_inertia = None
        while n_iter < params.max_iter:
            block = min(check, params.max_iter - n_iter)
            for _ in range(block):
                c, inertia, _ = step(c)
            n_iter += block
            limits.check_deadline(op)
            cur = float(inertia)
            if prev_inertia is not None:
                rel_change = abs(prev_inertia - cur) / max(prev_inertia,
                                                           1e-30)
                if rel_change <= params.tol:
                    converged = True
                    break
            prev_inertia = cur
    # the step's labels are against its input centroids: assign once more
    # so the returned triple is self-consistent
    dist, labels = _assign(x, c)
    inertia = torch.sum(dist) if w is None else torch.sum(dist * w)
    report = _finish_report(converged, n_iter, rel_change, params, strict,
                            op=op)
    if return_report:
        return c, inertia, labels, n_iter, report
    return c, inertia, labels, n_iter


def _minibatch_step(x, valid, *, n_clusters: int, chunk_rows: int):
    """The step of a mini-batch pass, ``(c, counts, j) -> ((c, counts,
    j + 1), done)``, one Sculley update; :class:`compiled_driver.ChunkLoop`
    runs it in chunks.

    Each step consumes one ``chunk_rows`` slice of the padded batch:
    nearest-centroid assignment (the fused argmin the full fit uses),
    then the count-weighted running-mean update
    ``c += (sums - n_assigned·c) / counts_new``: per-cluster learning
    rate 1/lifetime-count, so a cluster first touched this batch lands
    exactly on its batch mean and long-lived clusters move gently.
    ``valid`` zero-weights the pad rows. The slice's rows are gathered at
    ``j * chunk_rows + arange(chunk_rows)`` from the device cursor ``j``,
    so a captured graph reads the rows of the step it replays."""
    n_chunks = x.shape[0] // chunk_rows

    def step(carry):
        c, counts, j = carry
        # a masked step past the last slice reads the last slice again
        # (as dynamic_slice clamps) and its result is discarded
        jj = torch.clamp_max(j, n_chunks - 1).to(torch.int64)
        idx = jj * chunk_rows + torch.arange(chunk_rows, device=x.device)
        rows = x.index_select(0, idx)
        vw = valid.index_select(0, idx)
        dist, labels = _assign(rows, c)
        sums, cnt, _ = _weighted_sums(rows, vw, labels, dist, n_clusters)
        new_counts = counts + cnt
        safe = torch.where(new_counts > 0, new_counts, 1.0)
        cf = c.to(torch.float32)
        new_c = (cf + (sums - cnt[:, None] * cf)
                 / safe[:, None]).to(c.dtype)
        return (new_c, new_counts, j + 1), (j + 1) >= n_chunks

    return step


@with_matmul_precision
def kmeans_partial_fit(res, centroids, batch, *, counts=None,
                       chunk_rows: int = 256, sync_every=None,
                       checkpoint_dir: Optional[str] = None,
                       checkpoint_every: Optional[int] = None,
                       checkpoint_keep: int = 2,
                       resume_from: Optional[str] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One mini-batch k-means pass over ``batch`` (Sculley 2010): nudge
    ``centroids`` toward the stream without a full refit. Returns
    ``(new_centroids, new_counts)`` where ``counts`` is the float32
    per-cluster lifetime mass: thread it through successive calls so the
    per-cluster learning rate keeps decaying (``None`` starts cold: the
    first batch lands each touched cluster on its batch mean).

    ``centroids`` as a tensor sets the device (an array goes to the
    handle's), and an array ``batch`` follows it. The batch is consumed in ``chunk_rows`` slices through
    :func:`~raft_tpu_torch.runtime.compiled_driver.run_chunked`
    (``sync_every`` slices a chunk; on the card the chunks after the
    first replay a captured CUDA graph of one step), so the pass has the
    driver's checkpoint, deadline and trace boundary hooks.

    ``checkpoint_every`` (in boundary units; requires
    ``checkpoint_dir``) saves ``(centroids, counts, chunk)`` at chunk
    boundaries through :class:`~raft_tpu_torch.core.checkpoint
    .CheckpointManager` (prefix ``kmeans_pf``, newest
    ``checkpoint_keep`` kept), and ``resume_from`` (a checkpoint file
    or directory) restarts mid-batch from the saved chunk cursor: the
    SAME ``batch`` must be passed again, since the cursor indexes into
    it. The file format is the reference package's."""
    centroids = _as_data(centroids, res)
    if not isinstance(batch, torch.Tensor):
        batch = torch.as_tensor(np.asarray(batch), device=centroids.device)
    batch = _as_data(batch, res)
    if batch.device != centroids.device:
        raise ValueError(f"batch on {batch.device}, centroids on "
                         f"{centroids.device}")
    if centroids.dim() != 2:
        raise ValueError(f"centroids must be [k, d], got "
                         f"{tuple(centroids.shape)}")
    if batch.dim() != 2 or batch.shape[1] != centroids.shape[1]:
        raise ValueError(f"batch must be [n, {centroids.shape[1]}], "
                         f"got {tuple(batch.shape)}")
    if batch.shape[0] < 1:
        raise ValueError("batch must have at least one row")
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    n_clusters = int(centroids.shape[0])
    if counts is None:
        counts = torch.zeros((n_clusters,), dtype=torch.float32,
                             device=centroids.device)
    else:
        counts = torch.as_tensor(counts, dtype=torch.float32).to(
            centroids.device)
        if tuple(counts.shape) != (n_clusters,):
            raise ValueError(f"counts must be [{n_clusters}], got "
                             f"{tuple(counts.shape)}")
    n = int(batch.shape[0])
    chunk_rows = min(int(chunk_rows), n)
    n_chunks = -(-n // chunk_rows)
    pad = n_chunks * chunk_rows - n
    valid = torch.ones((n,), dtype=batch.dtype, device=batch.device)
    if pad:
        batch = torch.cat([batch, batch.new_zeros((pad, batch.shape[1]))])
        valid = torch.cat([valid, valid.new_zeros((pad,))])
    loop = compiled_driver.ChunkLoop(_minibatch_step(
        batch, valid, n_clusters=n_clusters, chunk_rows=chunk_rows))
    dims = dict(m=chunk_rows, k=int(batch.shape[1]),
                n_clusters=n_clusters, itemsize=batch.element_size())
    est = limits.estimate_seconds("cluster.lloyd_step",
                                  backend=hw.backend_of(batch.device),
                                  **dims)
    sf, sb = limits.estimate_flops_bytes("cluster.lloyd_step", **dims)
    sync = compiled_driver.resolve_sync_every(
        sync_every, step_seconds=est, device=batch.device)

    manager = None
    if checkpoint_every is not None:
        if checkpoint_dir is None:
            raise ValueError("checkpoint_every requires checkpoint_dir")
        from raft_tpu_torch.core import checkpoint as core_ckpt

        manager = core_ckpt.CheckpointManager(
            checkpoint_dir, prefix="kmeans_pf", keep=checkpoint_keep)
    start_chunk = 0
    if resume_from is not None:
        entries = _load_kmeans_checkpoint(resume_from, prefix="kmeans_pf")
        centroids = torch.as_tensor(np.asarray(entries["centroids"])).to(
            device=centroids.device, dtype=centroids.dtype)
        counts = torch.as_tensor(np.asarray(entries["counts"])).to(
            device=centroids.device, dtype=torch.float32)
        start_chunk = int(entries["chunk"])
        if start_chunk > n_chunks:
            raise ValueError(
                f"resume_from chunk {start_chunk} beyond this batch's "
                f"{n_chunks} chunks — pass the SAME batch the "
                "checkpoint was cut from")

    boundary = None
    if manager is not None:
        stride = sync * max(1, int(checkpoint_every))
        last_saved = [start_chunk if resume_from is not None else -1]

        def boundary(cr, steps_done, done_flag):
            if steps_done > 0 and (
                    steps_done - max(last_saved[0], 0) >= stride
                    or ((done_flag or steps_done >= n_chunks)
                        and steps_done != last_saved[0])):
                manager.save(steps_done, {
                    "centroids": cr[0].cpu().numpy(),
                    "counts": cr[1].cpu().numpy(),
                    "chunk": int(steps_done),
                })
                last_saved[0] = steps_done

    cursor = torch.full((), start_chunk, dtype=torch.int32,
                        device=centroids.device)
    carry = (centroids, counts, cursor)
    carry, n_steps, _ = compiled_driver.run_chunked(
        loop, carry, max_steps=n_chunks, sync_every=sync,
        op="cluster.kmeans_partial_fit", steps_done=start_chunk,
        est_step_seconds=est, step_flops=sf, step_bytes=sb,
        boundary=boundary)
    trace.record_event("kmeans.partial_fit", rows=n,
                       n_clusters=n_clusters, chunks=int(n_steps),
                       chunk_rows=chunk_rows)
    new_c, new_counts, _ = carry
    return new_c, new_counts


@with_matmul_precision
def kmeans_predict(res, x, centroids):
    """Assignment only: ``(labels, inertia)``."""
    x = _as_data(x, res)
    dist, labels = _assign(x, torch.as_tensor(centroids, device=x.device))
    return labels, torch.sum(dist)


@with_matmul_precision
def kmeans_transform(res, x, centroids):
    """Distance-to-centroid embedding [m, n_clusters] (L2, rooted)."""
    x = _as_data(x, res)
    return pairwise_distance(res, x, torch.as_tensor(centroids,
                                                     device=x.device),
                             metric=DistanceType.L2SqrtExpanded)


def kmeans_fit_predict(res, params: KMeansParams, x,
                       centroids: Optional[torch.Tensor] = None,
                       sample_weights=None, strict: bool = False,
                       return_report: bool = False):
    return kmeans_fit(res, params, x, centroids,
                      sample_weights=sample_weights, strict=strict,
                      return_report=return_report)


@with_matmul_precision
def cluster_cost(res, x, centroids):
    """Sum of squared distances of every point to its nearest centroid."""
    x = _as_data(x, res)
    dist, _ = _assign(x, torch.as_tensor(centroids, device=x.device))
    return torch.sum(dist)


# ---------------------------------------------------------------------------
# MNMG (one rank a process, over comms.device)
# ---------------------------------------------------------------------------


def _block_label_sums(x, labels, in_block, kb: int, w=None):
    """Per-centroid ``(sums [kb, d], counts [kb])`` of the rows whose
    label (local to the block) is in the block, from the labels alone:
    the keyed row sums of ``linalg.reduce`` (a stable sort into a CSR
    matrix [kb, m], its product with x the in-order segment sum of
    ``csrc/csr_spmm.cu``); the counts are the rows a label, or their
    weights' bincount. ``w`` weights the rows."""
    sums, hist = _sums_by_key(x, labels, in_block, kb, w)
    if w is None:
        return sums, hist.to(torch.float32)
    rows = torch.nonzero(in_block)[:, 0]
    return sums, torch.bincount(labels[rows].long(),
                                weights=w.to(torch.float32)[rows],
                                minlength=kb)


@with_matmul_precision
def mnmg_lloyd_step(x_shard, centroids, n_clusters: int,
                    data_axis: str = "data",
                    model_axis: Optional[str] = None,
                    w_shard=None):
    """One Lloyd iteration on this rank's shard: every rank of the mesh
    calls it with its own rows ``x_shard`` [m_local, d], inside
    :func:`raft_tpu_torch.comms.device.mesh_scope` (where the reference
    package traces it under ``shard_map``). Returns ``(new_centroids,
    inertia, labels)``, the centroids and inertia the same on every rank
    of the data axis, the labels this shard's.

    ``centroids`` is replicated [K, d], or this rank's block [K/s, d]
    when ``model_axis`` shards the cluster dimension. Data axis: the
    fused Lloyd pass (``csrc/fused_lloyd.cu``), then one all-reduce each
    of the sums, counts and inertia over the data axis — the reference's
    ncclAllReduce per iteration; over one rank it adds nothing, so the
    step is bitwise :func:`lloyd_step`. Model axis: the fused argmin
    (``csrc/fused_argmin.cu``) on the local block, a paired min over the
    model axis (the minimum distance, then the lowest global index among
    the ranks that hold it), the block's sums from the labels
    (:func:`_block_label_sums`), then the all-reduces over the data
    axis. ``w_shard`` [m_local] weights the rows, as ``sample_weight``.
    """
    from raft_tpu_torch.comms import device as dev

    x = x_shard.to(torch.float32).contiguous()
    c = centroids.to(device=x.device, dtype=torch.float32)
    w = None if w_shard is None else w_shard.to(device=x.device,
                                                dtype=torch.float32)
    if model_axis is not None:
        kb = c.shape[0]
        base = dev.rank(model_axis) * kb
        dist_l, local_idx = _assign(x, c)
        best = dev.allreduce(dist_l, dev.Op.MIN, axis_name=model_axis)
        winner = torch.where(dist_l == best, local_idx + base,
                             torch.iinfo(torch.int32).max)
        labels = dev.allreduce(winner.to(torch.int32), dev.Op.MIN,
                               axis_name=model_axis)
        in_block = (labels >= base) & (labels < base + kb)
        sums, counts = _block_label_sums(x, labels - base, in_block, kb, w)
        inertia_local = torch.sum(best) if w is None else torch.sum(best * w)
    elif w is not None:
        dist_l, labels = _assign(x, c)
        sums, counts, inertia_local = _weighted_sums(x, w, labels, dist_l,
                                                     n_clusters)
    else:
        sums, counts, dist_l, labels = fused_lloyd_pallas(x, c)
        inertia_local = torch.sum(dist_l)
    sums = dev.allreduce(sums, dev.Op.SUM, axis_name=data_axis)
    counts = dev.allreduce(counts, dev.Op.SUM, axis_name=data_axis)
    inertia = dev.allreduce(inertia_local, dev.Op.SUM, axis_name=data_axis)
    return _finish_update(sums, counts, c), inertia, labels


@with_matmul_precision
def kmeans_fit_mnmg(res, params: KMeansParams, x,
                    centroids: Optional[torch.Tensor] = None,
                    mesh=None, data_axis: str = "data",
                    model_axis: Optional[str] = None,
                    sample_weights=None,
                    checkpoint_every: Optional[int] = None,
                    checkpoint_dir: Optional[str] = None,
                    checkpoint_keep: int = 2,
                    resume_from: Optional[str] = None,
                    strict: bool = False,
                    return_report: bool = False,
                    sync_every: Optional[int] = None):
    """Multi-rank Lloyd over a row-partitioned dataset (BASELINE config 5):
    ``(centroids [K, d], inertia, labels [m], n_iter)``, the same on
    every rank.

    One process a rank, as :func:`mnmg_lloyd_step`: every rank of
    ``mesh`` (a ``DeviceMesh``; by default the handle's) calls this with
    the same global ``x`` [m, d] and works on its contiguous block of
    ``m / n_data`` rows, the block ``NamedSharding(P(data_axis))`` gives
    the reference package (so m must divide by the data axis's size).
    Each iteration is one :func:`mnmg_lloyd_step`; convergence is polled
    every ``check_every`` iterations and at ``max_iter``, as in the
    reference. ``model_axis`` shards the centroids in blocks of
    ``n_clusters / s``. ``sample_weights`` [m] weight the update.

    Elastic execution: ``checkpoint_every=n`` saves (centroids, previous
    inertia, iteration, RNG state) every n-th poll into
    ``checkpoint_dir`` (prefix ``kmeans``, :mod:`raft_tpu_torch.core.
    checkpoint`'s format), written by rank 0 of the mesh;
    ``resume_from`` is a checkpoint file or a directory whose newest
    checkpoint wins. With a :class:`~raft_tpu_torch.comms.MeshComms` on
    the handle, each poll then health-checks the clique
    (:meth:`~raft_tpu_torch.comms.MeshComms.ensure_healthy`, collective:
    it is also the barrier between rank 0's save and any read). On a
    peer failure the ranks agree on the survivors, shrink the clique,
    re-partition the rows over it, reload the newest checkpoint and
    finish there; a rank the others evicted raises
    :class:`~raft_tpu_torch.comms.CommsAbortedError` after taking part
    in the shrink. The deadline poll of ``runtime.limits`` follows the
    health probe.

    ``centroids`` (explicit) start the fit; otherwise k-means|| on the
    global x, the same on every rank (torch's generators: the reference
    package's seeds are not its bits). ``sync_every > 1`` raises
    ``NotImplementedError``."""
    from raft_tpu_torch.comms import device as dev
    from raft_tpu_torch.comms.errors import CommsAbortedError, PeerFailedError
    from raft_tpu_torch.core import checkpoint as core_ckpt
    from raft_tpu_torch.core import logger, trace
    from raft_tpu_torch.core import resources as core_res
    from raft_tpu_torch.runtime import limits

    op = "cluster.kmeans_fit_mnmg"
    handle = core_res.default_resources(res)
    x = _as_data(x, handle)
    expect_2d(x, name="kmeans_fit_mnmg: x")
    expect_finite(x, name="kmeans_fit_mnmg: x")
    w = None
    if sample_weights is not None:
        w = torch.as_tensor(sample_weights, device=x.device)
        _validate_sample_weights(w, x.shape[0])
        w = w.to(torch.float32)
    expect_one_sync(sync_every, "kmeans_fit_mnmg")
    if mesh is None:
        mesh = core_res.get_mesh(handle)
    n_blocks = 1
    if model_axis is not None:
        with dev.mesh_scope(mesh):
            n_blocks = dev.size(model_axis)
        if params.n_clusters % n_blocks:
            raise ValueError(
                f"n_clusters={params.n_clusters} not divisible by "
                f"model axis {model_axis!r} size {n_blocks}")
    comms = (core_res.get_comms(handle)
             if core_res.comms_initialized(handle) else None)
    manager = None
    if checkpoint_every is not None:
        if checkpoint_dir is None:
            raise ValueError("checkpoint_every requires checkpoint_dir")
        manager = core_ckpt.CheckpointManager(checkpoint_dir,
                                              prefix="kmeans",
                                              keep=checkpoint_keep)

    state = RngState(seed=params.seed)
    prev = None
    start_iter = 0
    if resume_from is not None:
        entries = _load_kmeans_checkpoint(resume_from)
        c_full = torch.as_tensor(entries["centroids"]).to(
            device=x.device, dtype=x.dtype)
        start_iter = int(entries["n_iter"])
        prev = entries["prev_inertia"]
        if prev is not None and not np.isfinite(prev):
            prev = None
        state = entries.get("rng", state)
    else:
        c_full = _init_centroids(params, x, centroids, sample_weights=w)
    kb = params.n_clusters // n_blocks

    def build(cur_mesh, c_all):
        """This rank's rows (and weights) and centroid block on
        ``cur_mesh``; the rows are the reference's ``P(data_axis)``
        block."""
        with dev.mesh_scope(cur_mesh):
            nd = dev.size(data_axis)
            if x.shape[0] % nd:
                raise ValueError(
                    f"kmeans_fit_mnmg: {x.shape[0]} rows do not split evenly"
                    f" over the {nd} ranks of axis {data_axis!r}")
            per = x.shape[0] // nd
            lo = dev.rank(data_axis) * per
            cb = 0 if model_axis is None else dev.rank(model_axis) * kb
            writer = (dev.rank(data_axis) == 0
                      and (model_axis is None or dev.rank(model_axis) == 0))
        xs = x[lo:lo + per]
        ws = None if w is None else w[lo:lo + per]
        return xs, ws, c_all[cb:cb + kb].clone(), writer

    def step(cur_mesh, xs, ws, c):
        with dev.mesh_scope(cur_mesh):
            return mnmg_lloyd_step(xs, c, kb, data_axis=data_axis,
                                   model_axis=model_axis, w_shard=ws)

    def full(cur_mesh, c):
        """The whole [K, d] centroids from the model axis's blocks."""
        if model_axis is None:
            return c
        with dev.mesh_scope(cur_mesh):
            return dev.allgather(c, axis_name=model_axis, tiled=True)

    xs, ws, c, writer = build(mesh, c_full)
    n_iter = start_iter
    check = max(1, int(params.check_every))
    ckpt_stride = (None if manager is None
                   else check * max(1, int(checkpoint_every)))
    converged = False
    rel_change = float("inf")
    while n_iter < params.max_iter:
        try:
            converged = False
            for n_iter in range(n_iter + 1, params.max_iter + 1):
                c, inertia, _ = step(mesh, xs, ws, c)
                if n_iter % check and n_iter != params.max_iter:
                    continue             # no host sync between polls
                # checkpoint BEFORE the health probe: recovery resumes
                # from this very boundary
                if ckpt_stride is not None and (
                        n_iter % ckpt_stride == 0
                        or n_iter == params.max_iter):
                    c_all = full(mesh, c)
                    if writer:
                        manager.save(n_iter, {
                            "centroids": c_all,
                            "prev_inertia": (float("inf") if prev is None
                                             else float(prev)),
                            "n_iter": int(n_iter),
                            "rng": state,
                        })
                if comms is not None:
                    comms.ensure_healthy()
                limits.check_deadline(op)
                cur = float(inertia)
                if prev is not None:
                    rel_change = abs(prev - cur) / max(prev, 1e-30)
                    if rel_change <= params.tol:
                        converged = True
                        break
                prev = cur
            if converged or n_iter >= params.max_iter:
                break
        except (PeerFailedError, CommsAbortedError) as e:
            if comms is None or manager is None:
                raise
            latest = manager.restore_latest()
            if latest is None:
                raise
            logger.warn("kmeans_fit_mnmg: clique failure at iteration %d "
                        "(%r); recovering on survivors", n_iter, e)
            survivors = comms.agree_on_survivors()
            comms = comms.shrink(survivors)     # an evicted rank raises
            core_res.set_comms(handle, comms)
            mesh = comms.mesh
            step_at, entries = latest
            prev = entries["prev_inertia"]
            if not np.isfinite(prev):
                prev = None
            state = entries.get("rng", state)
            xs, ws, c, writer = build(mesh, torch.as_tensor(
                entries["centroids"]).to(device=x.device, dtype=x.dtype))
            n_iter = int(entries["n_iter"])
            trace.record_event("kmeans.elastic_resume", iteration=n_iter,
                               checkpoint_step=step_at,
                               survivors=tuple(survivors))
    # re-assign against the FINAL centroids for a self-consistent return:
    # one more step gives labels and inertia against c (its centroid
    # update is discarded)
    _, inertia, labels = step(mesh, xs, ws, c)
    with dev.mesh_scope(mesh):
        labels = dev.allgather(labels, axis_name=data_axis, tiled=True)
    c = full(mesh, c)
    report = _finish_report(converged, n_iter, rel_change, params, strict,
                            op=op)
    if return_report:
        return c, inertia, labels, n_iter, report
    return c, inertia, labels, n_iter


def _load_kmeans_checkpoint(resume_from: str, prefix: str = "kmeans"):
    """Resolve ``resume_from`` (a checkpoint file, or a directory whose
    newest checkpoint wins) to its entry dict."""
    import os

    from raft_tpu_torch.core import checkpoint as core_ckpt

    if os.path.isdir(resume_from):
        latest = core_ckpt.CheckpointManager(
            resume_from, prefix=prefix).restore_latest()
        if latest is None:
            raise FileNotFoundError(
                f"no {prefix} checkpoints in {resume_from!r}")
        return latest[1]
    return core_ckpt.restore_checkpoint(resume_from)


def kmeans_fit_elastic(comms, params: KMeansParams, x,
                       sample_weights=None,
                       checkpoint_every: Optional[int] = None,
                       checkpoint_dir: Optional[str] = None,
                       checkpoint_keep: int = 2,
                       resume_from: Optional[str] = None,
                       on_iteration=None):
    """Host-driven elastic Lloyd that survives the death of a rank's
    process: ``(centroids [k, d] float64, inertia, n_iter, comms)``.

    A ``torch.distributed`` world cannot outlive a killed process, so
    this fit keeps its reduction on the host:
    :meth:`~raft_tpu_torch.comms.MeshComms.host_allreduce` over the
    clique's mailbox, a host-only clique over a
    :class:`~raft_tpu_torch.comms.TcpMailbox` across processes. The
    first rank to see a peer fail aborts the clique (waking every
    blocked peer within a heartbeat); the survivors quiesce, agree on
    the live set, shrink, re-partition the rows over the new size,
    reload rank 0's newest checkpoint (prefix ``kmeans_host``) and go
    on.

    Every rank passes the same full ``x``; rank r computes partials for
    its contiguous row block (a function of (rows, size, rank) only)
    with :func:`~raft_tpu_torch.matrix.epilogue.host_assign_update`, in
    numpy f64, reduced in ascending rank order, so a run that lost a
    rank is bit for bit a clean run of the survivors' size resumed from
    the same checkpoint. The initial centroids are the reference's draw
    (``np.random.default_rng(seed)``), so the two packages agree bit for
    bit. ``on_iteration(it, centroids)`` fires after every update. The
    returned clique is the live one (after a shrink, the caller's old
    handle is stale)."""
    import time as _time

    from raft_tpu_torch.comms.errors import CommsAbortedError, PeerFailedError
    from raft_tpu_torch.core import checkpoint as core_ckpt
    from raft_tpu_torch.core import logger, trace
    from raft_tpu_torch.matrix.epilogue import host_assign_update
    from raft_tpu_torch.runtime import limits

    x = np.asarray(x, np.float64)
    n, d = x.shape
    k = int(params.n_clusters)
    if k <= 0 or k > n:
        raise ValueError(f"need 0 < n_clusters <= n_rows, got {k} vs {n}")
    w = (np.ones(n, np.float64) if sample_weights is None
         else np.asarray(sample_weights, np.float64))
    _validate_sample_weights(torch.as_tensor(w), n)
    manager = None
    if checkpoint_every is not None:
        if checkpoint_dir is None:
            raise ValueError("checkpoint_every requires checkpoint_dir")
        manager = core_ckpt.CheckpointManager(checkpoint_dir,
                                              prefix="kmeans_host",
                                              keep=checkpoint_keep)
    if resume_from is not None:
        entries = _load_kmeans_checkpoint(resume_from, prefix="kmeans_host")
        c = np.asarray(entries["centroids"], np.float64)
        it = int(entries["n_iter"])
    else:
        rng = np.random.default_rng(params.seed)
        c = x[np.sort(rng.choice(n, size=k, replace=False))].copy()
        it = 0

    inertia = float("inf")
    stride = max(1, int(checkpoint_every)) if checkpoint_every else None
    while it < params.max_iter:
        try:
            while it < params.max_iter:
                limits.check_deadline("cluster.kmeans_fit_elastic")
                it += 1
                size, rank = comms.get_size(), comms.get_rank()
                bounds = np.linspace(0, n, size + 1).astype(np.int64)
                lo, hi = int(bounds[rank]), int(bounds[rank + 1])
                xs, ws = x[lo:hi], w[lo:hi]
                _, sums, counts, best = host_assign_update(xs, ws, c)
                buf = np.concatenate(
                    [sums.ravel(), counts, [float((best * ws).sum())]])
                tot = comms.host_allreduce(buf, tag=2 * it)
                gsums = tot[:k * d].reshape(k, d)
                gcounts = tot[k * d:k * d + k]
                inertia = float(tot[-1])
                new_c = np.where(gcounts[:, None] > 0,
                                 gsums / np.maximum(gcounts, 1.0)[:, None],
                                 c)
                shift = float(np.abs(new_c - c).max())
                c = new_c
                if on_iteration is not None:
                    on_iteration(it, c)
                converged = shift <= params.tol
                done = converged or it >= params.max_iter
                if stride is not None and it % stride == 0:
                    # rank 0 of the CURRENT clique writes; the save comes
                    # before the health probe, so recovery resumes from
                    # exactly this boundary
                    if rank == 0:
                        manager.save(it, {"centroids": c,
                                          "n_iter": int(it),
                                          "prev_inertia": inertia})
                    # the probe protects the NEXT allreduce; after the
                    # last one peers may already have closed, and their
                    # goodbye must not read as a failure
                    if not done:
                        comms.ensure_healthy()
                if converged:
                    return c, inertia, it, comms
            return c, inertia, it, comms
        except (PeerFailedError, CommsAbortedError) as e:
            if manager is None:
                raise
            if isinstance(e, PeerFailedError):
                # the first detector poisons the clique, so peers blocked
                # in the allreduce wake now instead of at their timeout
                comms.abort(f"kmeans_fit_elastic: {e}")
            # quiesce: other detectors' aborts land within about one
            # heartbeat; outlive them before clearing
            _time.sleep(2.0 * comms.heartbeat_interval)
            comms.clear_abort()
            survivors = comms.agree_on_survivors()
            comms = comms.shrink(survivors)
            latest = manager.restore_latest()
            if latest is None:
                raise
            step_at, entries = latest
            c = np.asarray(entries["centroids"], np.float64)
            it = int(entries["n_iter"])
            logger.warn("kmeans_fit_elastic: clique failure (%r); resuming "
                        "iteration %d on %d survivors", e, it,
                        len(survivors))
            trace.record_event("kmeans.elastic_host_resume",
                               checkpoint_step=step_at, iteration=it,
                               survivors=tuple(survivors))
    return c, inertia, it, comms
