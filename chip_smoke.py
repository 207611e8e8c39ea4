#!/usr/bin/env python3
"""Quickest proof that raft_tpu_torch runs on a CUDA card.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit's ``nvcc`` and this checkout. It
builds the port's twelve CUDA kernels from ``raft_tpu_torch/csrc``
(one ``nvcc`` each, all at once), holds each against its plain PyTorch
version on the card (the contraction kernels at all three precision
tiers, the selection kernels at ragged shapes with ties, NaN and inf,
the unexpanded tile at every metric in f32, bf16 and f64 with zero, NaN
and inf entries, the MST E-stage on a 100,000-entry hub row under four
colorings, the 1-NN probe over many database splits), and drives these
paths, each with the launch counts set to 0 just before it and read
just after:

- k-means (Lloyd) on 1,000,000 x 128 f32 with k = 1024 at tier 'high',
  then the distance embedding of the data;
- pairwise_distance at BASELINE config 1's 5000 x 50: the five expanded
  metrics and the seven unexpanded ones;
- brute-force kNN, db 1,048,576 x 128 f32, 4096 queries, tier 'high':
  k = 64 and k = 256 (the fused route), k = 1024 (the radix route); l1
  at k = 64 (the radix route through the unexpanded tile, 32 chunks),
  linf and canberra at k = 64 with 256 queries;
- select_k: AUTO on 64 x 2^20 f32, k = 2048 (radix), and
  WARPSORT_FILTERED on 1024 x 65,536 f32, k = 64 (insertion), on
  random, descending and ascending rows;
- the tune-only 1-NN probe at the kNN shape, beside the fused top-k at
  k = 1, 64 and 256 (the gap is the selection's share);
- a k sweep at the kNN shape: the fused route against the radix route
  at k = 16, 64, 128 and 256 (the dispatch bands stay the reference's);
- BASELINE config 4: the R-MAT graph (scale 20, 10M edges, about 19M
  stored entries) built on the card by the port's generator, one SpMV,
  one SpMM at k = 16 and the fixed 3-restart Lanczos (52 steps);
- spectral partition of a planted 4-block graph of the same size, then
  both analyzers: the blocks must be recovered (agreement >= 0.99, edge
  cut within 1% of the planted one) with a converged Lanczos;
- Borůvka MST on bench_mst's graph (R-MAT scale 20, 10M edges, random
  weights): n - n_components forest edges, the f64 total weight equal to
  scipy's, and forest and colors equal to the plain E-stage's.

The CSR kernels are first held against their plain versions on a hub
row of 100,000 entries, empty rows, an empty matrix, a stored zero
against inf, a padded CSR, a non-square matrix, f64 and k = 1 to 64.
It then holds every kernel against its plain version at the shapes
those paths give it (the kNN radix route's 4096 x 32,768 chunk of
distances and config 4's graph included) and times it there, with
``pairwise_tile``'s tile at each tier (wgmma at 'default' and 'high',
the FMA tile at 'highest'), ``fused_argmin`` on its tile and walk at
each tier (l2, cosine and inner at config 3's shape, the k-means||
candidate shape, the kNN shape and the spectral partition's shape, with
``kmeans_predict``'s time; its plan at those shapes on an
``argmin_plan`` line, worked out, not measured),
``fused_topk`` at k = 64 and 256 at each
tier beside the time of its operands' preparation (the split into bf16
halves, the wgmma route's bf16 rows) on the 2^20-row database, the
count of HGMMA instructions in the built libraries of
``pairwise_tile``, ``fused_argmin``, ``fused_lloyd``, ``fused_topk`` and
``minonly`` (where the toolkit has ``cuobjdump``), the Lloyd pass split
into its argmin and its sums by kernel name from a ``torch.profiler``
trace (every output bitwise
equal on two argmin grids), its plan at BASELINE config 5's shape (not
run), the fused top-k's split plan at the kNN shape (a ``topk_plan``
line; worked out, not measured), radix_threshold's and radix_emit's
plans at the kNN chunks and the select shape (``radix_plan`` and
``emit_plan`` lines; worked out, not measured), the instruction mix of each f32 ``unexpanded_tile`` kernel
counted in its SASS (an ``unexpanded_sass`` line; no FFMA in l1, linf,
hamming or l2un, no register spill, and a failure where the toolkit has
no ``cuobjdump``), ``unexpanded_tile`` at every metric at the l1 kNN
route's chunk (bitwise equal to its plain version but lp), the
threshold and the emission at that chunk's keys (the emission also in
its look-back form, which the plan leaves to fewer rows) and, at the l2
chunk,
the threshold on rows of equal keys (the row's read alone), the emission
at the select shape on sorted and reverse-sorted rows, the MST E-stage's
split (an ``mst_plan`` line) and its time at every Borůvka round, each
round's triples held exactly against the plain version, a trace of k-means iterations (the card's
busy time and idle share), and ``csr_spmv`` and ``csr_spmm`` on config
4 with and without its longest row (the hub row's share). Each
phase prints one JSON line; the line before the last is the card's name
and power limit from ``nvidia-smi``, the last is the result. Longer
output (compiler logs, all numbers) goes to
``chiprun_out/chip_smoke.json``. Any failed check raises, and the script
exits non-zero; without CUDA it exits non-zero before printing any
result.

    python3 chip_smoke.py --fingerprint ROOT

hashes the outputs of ``pairwise_tile``, ``fused_lloyd``, ``fused_topk``,
``minonly``, ``topk_insert``, ``unexpanded_tile``, ``radix_threshold``,
``radix_emit``, ``csr_spmv`` and ``mst_min_edge`` on seeded inputs, and
of the kNN,
select_k and mst calls that run the radix and MST kernels, and times
them at the main paths' shapes,
from the ``raft_tpu_torch`` package under ROOT: run on this checkout and
on another commit's package in turns, it shows whether a change kept
those kernels bit for bit, and their times.
"""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

SEED = 20261016
MAIN_M, MAIN_K, MAIN_N, MAIN_ITERS = 1_000_000, 128, 1024, 10
PAIRWISE_M, PAIRWISE_K = 5000, 50          # BASELINE config 1
# neighbors/knn_l2 (benches/bench_prims.py:1146): db, queries, dims
KNN_N, KNN_Q, KNN_D = 1 << 20, 4096, 128
KNN_KS = (64, 256, 1024)                   # fused, fused, radix
KNN_SAMPLE = 64                            # queries checked against f64
# matrix/select_k_bars (bench_prims.py:382) and the insert route's rows
SELECT_RADIX = (64, 1 << 20, 2048)
SELECT_INSERT = (1024, 65536, 64)
PLAIN_Q = 256      # queries of the fused top-k's plain version at full n
REL = 1e-5            # bf16x3 / f32 agreement between two f32 summation orders
# H100 SXM peaks at 700 W (dense bf16 tensor-core rate, HBM3 bandwidth)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# BASELINE config 4 (bench_prims.py:877-893): R-MAT scale 20, 10M edges
RMAT_SCALE, RMAT_EDGES = 20, 10_000_000
SPMM_K = 16                                # bench_prims.py:684
SPARSE_KS = (1, 2, 31, 32, 33, 64)         # SpMM widths held to plain
SPARSE_REL = 2e-5      # x (|A|.|x|)_row: two f32 summation orders
SPARSE_REL_F64 = 1e-12  # the same in f64; an f32 sum would miss by ~1e-7
# planted partition of config-4 size: 4 blocks, 98% of edges inside
PLANTED_BLOCKS, PLANTED_EDGES, PLANTED_INSIDE = 4, 9_500_000, 0.98
# unexpanded metrics: kernel vocabulary, those exact on integer inputs in
# any summation order, and lane instructions per (i, j, c) element (a
# subtract, then an add or max with |.| as a free modifier; hamming a
# compare and a predicated add; l2un a subtract, a multiply and an add,
# three because bitwise parity with the plain version's separately rounded
# d * d and acc + v forbids an FFMA; canberra's IEEE divide about 10 more;
# lp's powf about 20)
UNEXP_METRICS = ("l1", "linf", "canberra", "lp", "hamming", "l2un")
UNEXP_EXACT = ("l1", "linf", "hamming")
UNEXP_BITWISE = ("l1", "linf", "canberra", "hamming", "l2un")
UNEXP_INSTR = {"l1": 2, "linf": 2, "hamming": 2, "l2un": 3, "canberra": 12,
               "lp": 22}
UNEXP_K, UNEXP_Q = 64, 256                 # kNN k; linf/canberra queries
# H100 SXM f32 lane-instruction issue rate: 132 SMs x 128 lanes x 1.98 GHz
PEAK_LANE_INSTR = 132 * 128 * 1.98e9
OUT_DIR = "chiprun_out"
RECORD = {}


def emit(phase, **fields):
    RECORD.setdefault("phases", []).append({"phase": phase, **fields})
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up run (CUDA events around the whole batch)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def labels_agree(got, want, dist_rows, scale, rel, what):
    """Labels equal except at near-ties: on each row where they differ,
    the plain distances to the two labels (``dist_rows(rows)`` gives the
    plain version's [len(rows), n] distances of those rows) lie within
    rel * scale of each other. Returns the rows that differ."""
    import torch

    bad = torch.nonzero(got.long() != want.long())[:, 0]
    check(bad.numel() <= max(1, got.numel() // 1000),
          f"{what}: {bad.numel()} of {got.numel()} labels differ")
    if bad.numel():
        d = dist_rows(bad)
        at = torch.arange(bad.numel(), device=d.device)
        gap = (d[at, got[bad].long()] - d[at, want[bad].long()]).abs()
        check(bool((gap <= rel * scale[bad]).all()),
              f"{what}: labels differ outside the tie band")
    return bad


def side_rows(side, rows):
    """The operand rows ``rows`` of one contraction side."""
    from raft_tpu_torch.linalg import contractions as tc

    return tc.Side(side.v0[rows], None if side.v1 is None else side.v1[rows],
                   side.norms[rows])


def plain_rows(tier, metric, xs, ys, n, k):
    """``dist_rows`` for :func:`labels_agree`: the plain distances of
    some rows of x against all of y."""
    from raft_tpu_torch.linalg import contractions as tc

    return lambda rows: tc._pairwise_plain(tier, metric, side_rows(xs, rows),
                                           ys, rows.numel(), n, k)


def check_lloyd_sums(tier, xs, got, want, m, n, k, what):
    """A Lloyd pass's counts and sums. Counts must equal the bincount of
    the kernel's labels, and the plain version's on every cluster that no
    row with a differing label touches. Sums must equal the rows summed
    under the kernel's own labels on every cluster, and the plain sums on
    those untouched clusters, to REL x the cluster's |x| mass: the two
    differ only in f32 summation order. Returns the max abs error and
    the max of error over mass."""
    import torch

    sums, counts, _, idx = got
    psums, pcounts, _, pidx = want
    lab = idx.long()
    check(torch.equal(counts, torch.bincount(lab, minlength=n).float()),
          f"{what}: counts != bincount(labels)")
    if tier == "high":       # hi and lo halves, summed apart as the kernel does
        parts = [xs.v0[:m, :k].float(), xs.v1[:m, :k].float()]
    elif tier == "default":  # the bf16-rounded rows
        parts = [xs.v0[:m, :k].to(torch.bfloat16).float()]
    else:
        parts = [xs.v0[:m, :k]]
    own = torch.zeros(n, k, device=sums.device)
    mass = torch.zeros(n, k, device=sums.device)
    for p in parts:
        own += torch.zeros(n, k, device=sums.device).index_add_(0, lab, p)
        mass.index_add_(0, lab, p.abs())
    err = (sums - own).abs()
    check(bool((err <= REL * mass + 1e-6).all()),
          f"{what}: sums off the kernel's own labels by {float(err.max())}")
    differ = lab != pidx.long()
    touched = torch.zeros(n, dtype=torch.bool, device=sums.device)
    touched[lab[differ]] = True
    touched[pidx.long()[differ]] = True
    clean = ~touched
    check(torch.equal(counts[clean], pcounts[clean]),
          f"{what}: counts differ from the plain version")
    err_plain = (sums - psums).abs()[clean]
    check(bool((err_plain <= REL * mass[clean] + 1e-6).all()),
          f"{what}: sums off the plain version by {float(err_plain.max())}")
    live = mass > 0
    rel = max(float((err / mass)[live].max()) if bool(live.any()) else 0.0,
              float((err_plain / mass[clean])[live[clean]].max())
              if bool(live[clean].any()) else 0.0)
    return max(float(err.max()),
               float(err_plain.max()) if err_plain.numel() else 0.0), rel


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version, all tiers
# ---------------------------------------------------------------------------


def parity(dev):
    import torch

    from raft_tpu_torch.linalg import contractions as tc

    gen = torch.Generator(device=dev).manual_seed(SEED)
    m, n, k = 517, 301, 45                      # ragged: no tile multiples
    x = torch.randn(m, k, generator=gen, device=dev)
    y = torch.randn(n, k, generator=gen, device=dev)
    y[200] = y[17]                              # tied column pair
    x[0] = y[17]                                # ... nearest for row 0
    x_nan = x.clone()
    x_nan[5] = float("nan")                     # NaN row for the argmin
    xn64 = (x.double() ** 2).sum(1)
    yn64 = (y.double() ** 2).sum(1)
    scale_l2 = (xn64[:, None] + yn64[None, :]).float()
    scales = {"l2": scale_l2, "cosine": torch.ones_like(scale_l2),
              "inner": (xn64[:, None] * yn64[None, :]).sqrt().float()}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mb = 2 * sms * tc.TILE_M + 77               # Lloyd rows: ~2 tiles a block
    xb = torch.randn(mb, k, generator=gen, device=dev)
    scale_b = ((xb.double() ** 2).sum(1) + yn64.max()).float()
    errs = {"pairwise_tile": 0.0, "fused_argmin": 0.0, "fused_lloyd": 0.0}
    mismatches = 0
    for tier in ("default", "high", "highest"):
        xs, ys = tc._side(x, tier), tc._side(y, tier)
        for metric in ("l2", "cosine", "inner"):
            scale = scales[metric]
            got = tc._pairwise_tile(tier, metric, xs, ys, m, n, k)
            again = tc._pairwise_tile(tier, metric, xs, ys, m, n, k)
            check(torch.equal(got, again), f"pairwise {tier} {metric}: "
                  "two runs differ")
            want = tc._pairwise_plain(tier, metric, xs, ys, m, n, k)
            err = (got - want).abs()
            check(bool((err <= REL * scale + 1e-6).all()),
                  f"pairwise {tier} {metric}: max err {float(err.max())}")
            errs["pairwise_tile"] = max(errs["pairwise_tile"],
                                        float(err.max()))

            for xx in (x, x_nan):
                xxs = tc._side(xx, tier)
                v, i = tc._fused_argmin(tier, metric, xxs, ys, m, n, k)
                v2, i2 = tc._fused_argmin(tier, metric, xxs, ys, m, n, k)
                check(torch.equal(i, i2) and torch.equal(
                    v.view(torch.int32), v2.view(torch.int32)),
                    f"argmin {tier} {metric}: two runs differ")
                pv, pi = tc._argmin_plain(tier, metric, xxs, ys, m, n, k)
                dfull = tc._pairwise_plain(tier, metric, xxs, ys, m, n, k)
                live = torch.ones(m, dtype=torch.bool, device=dev)
                if xx is x_nan:
                    live[5] = False
                    check(int(i[5]) == 0 == int(pi[5])
                          and bool(torch.isnan(v[5])),
                          f"argmin {tier} {metric}: NaN row not minimal")
                mismatches += labels_agree(
                    i[live], pi[live], lambda r, d=dfull[live]: d[r],
                    scale.max(1).values[live], REL,
                    f"argmin {tier} {metric}").numel()
                check(int(i[0]) == 17 or metric != "l2",
                      f"argmin {tier}: tie not won by the smaller index")
                same = live & (i == pi)
                err = (v - pv).abs()[same]
                check(bool((err <= REL * scale.max(1).values[same]
                            + 1e-6).all()),
                      f"argmin {tier} {metric}: max err {float(err.max())}")
                errs["fused_argmin"] = max(errs["fused_argmin"],
                                           float(err.max()))

        # Lloyd: operands with 23 junk rows past m, which must never count;
        # on the default grid (one row tile a block) and on two blocks
        # (three and two row tiles a block), which must give the same
        # labels, distances, counts and sums, bit for bit
        junk = 23
        xp = torch.cat([x, torch.full((junk, k), 7e3, device=dev)])
        xps = tc._side(xp, tier)
        want = tc._lloyd_plain(tier, xs, ys, m, n, k)
        first = None
        for blocks in (None, 2):
            what = f"lloyd {tier} on {blocks or 'default'} blocks"
            out, err = lloyd_parity(tier, xps, ys, want, m, n, k,
                                    scale_l2.max(1).values, what, blocks)
            mismatches += out[-1]
            errs["fused_lloyd"] = max(errs["fused_lloyd"], err)
            if first is None:
                first = out
            else:
                check(all(torch.equal(a, b) for a, b in zip(out[:4],
                                                            first[:4])),
                      f"{what}: labels, distances, counts or sums changed "
                      "with the grid")

        # the full persistent grid with several row tiles a block and a
        # ragged last tile, as at the main shape
        xbs = tc._side(xb, tier)
        check(-(-mb // tc.TILE_M) > tc._lloyd_plan(mb, n, k, sms).grid,
              "many-tile case has no more row tiles than blocks")
        want = tc._lloyd_plain(tier, xbs, ys, mb, n, k)
        out, err = lloyd_parity(tier, xbs, ys, want, mb, n, k, scale_b,
                                f"lloyd {tier} at {mb} rows")
        mismatches += out[-1]
        errs["fused_lloyd"] = max(errs["fused_lloyd"], err)
    emit("parity", shape=[m, n, k], lloyd_many_tiles_rows=mb,
         tiers=["default", "high", "highest"],
         metrics=["l2", "cosine", "inner"], max_abs_err=errs,
         near_tie_label_mismatches=mismatches, bitwise_repeatable=True,
         tolerance=f"|kernel - plain| <= {REL} x (|x|^2 + |y|^2) for l2, "
                   f"{REL} for cosine, {REL} x |x||y| for inner; labels "
                   f"equal except within that band; Lloyd sums within {REL}"
                   " x the cluster's |x| mass; counts exact")
    return errs


def lloyd_parity(tier, xs, ys, want, m, n, k, dscale, what, blocks=None):
    """One fused Lloyd pass held against its plain version ``want``: two
    runs bitwise equal, padded rows never counted, labels equal except
    at near-ties, distances and sums within REL. Returns the kernel's
    output with the count of differing labels appended, and the max abs
    error."""
    import torch

    from raft_tpu_torch.linalg import contractions as tc

    out = tc._fused_lloyd(tier, xs, ys, m, n, k, blocks)
    again = tc._fused_lloyd(tier, xs, ys, m, n, k, blocks)
    for a, b in zip(out, again):
        check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
              f"{what}: two runs differ")
    val = out[2]
    check(float(out[1].sum()) == m, f"{what}: padded rows counted")
    bad = labels_agree(out[3], want[3], plain_rows(tier, "l2", xs, ys, n, k),
                       dscale, REL, what)
    err_sums, _ = check_lloyd_sums(tier, xs, out, want, m, n, k, what)
    err = (val - want[2]).abs()
    check(bool((err <= REL * dscale + 1e-6).all()),
          f"{what}: dist max err {float(err.max())}")
    return out + (int(bad.numel()),), max(err_sums, float(err.max()))


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def blobs(gen, dev, m, k, centers, spread=1.0, box=4.0):
    import torch

    mu = box * torch.randn(centers, k, generator=gen, device=dev)
    lab = torch.randint(0, centers, (m,), generator=gen, device=dev)
    return mu[lab] + spread * torch.randn(m, k, generator=gen, device=dev)


def main_path(res, dev):
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.cluster import kmeans as tk
    from raft_tpu_torch.util import precision as tprec

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = blobs(gen, dev, MAIN_M, MAIN_K, MAIN_N)
    c0 = x[torch.randperm(MAIN_M, generator=gen, device=dev)[:MAIN_N]]
    params = tk.KMeansParams(n_clusters=MAIN_N, max_iter=MAIN_ITERS, tol=0.0,
                             init=tk.KMeansInit.ARRAY)
    start_cost = float(tk.cluster_cost(res, x, c0))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with tprec.scope("high"):
        c, inertia, labels, n_iter = tk.kmeans_fit(res, params, x, c0)
        emb = tk.kmeans_transform(res, x, c)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    for name in ("pairwise_tile", "fused_argmin", "fused_lloyd"):
        check(launches[name] > 0, f"main path never launched {name}")
    check(n_iter == MAIN_ITERS, f"n_iter {n_iter} != {MAIN_ITERS} at tol 0")
    check(tuple(c.shape) == (MAIN_N, MAIN_K) and bool(torch.isfinite(c).all()),
          "centroids not finite [1024, 128]")
    check(labels.shape == (MAIN_M,) and int(labels.min()) >= 0
          and int(labels.max()) < MAIN_N, "labels out of range")
    check(bool(torch.isfinite(inertia)) and float(inertia) < start_cost,
          f"inertia {float(inertia)} not below the start {start_cost}")
    check(tuple(emb.shape) == (MAIN_M, MAIN_N)
          and bool(torch.isfinite(emb).all()), "embedding not finite")
    # the embedding's nearest centroid is the fit's label, but at near-ties
    dscale = ((x.double() ** 2).sum(1) + (c.double() ** 2).sum(1).max()
              ).float()
    emb_lab = emb.argmin(1)
    bad = labels_agree(emb_lab, labels, lambda r: emb[r] ** 2, dscale, REL,
                       "embedding argmin vs fit labels")
    agree = 1.0 - bad.numel() / MAIN_M
    del emb, emb_lab

    # steady-state iteration time on the prepared operands; a trace of the
    # same iterations (the card's busy time, its idle share between the
    # first kernel's start and the last one's end, the host's runtime
    # calls); the assignment alone (kmeans_predict: fused_argmin)
    with tprec.scope("high"):
        ops, meta = tk.lloyd_prepare(x, MAIN_N)

        def step():
            return tk.lloyd_step_prepared(ops, c, **meta)

        it_ms = cuda_ms(step, 20)
        reps = 10
        events, runtime = device_trace(step, reps)
        span = max(e for _, _, e in events) - min(s for _, s, _ in events)
        busy = busy_us(events)
        predict_ms = cuda_ms(lambda: tk.kmeans_predict(res, x, c), 5)
    emit("main_path", shape=[MAIN_M, MAIN_K], n_clusters=MAIN_N,
         tier="high", n_iter=n_iter, inertia=float(inertia),
         start_cost=start_cost, wall_s=wall, ms_per_iter=it_ms,
         iters_per_s=1000.0 / it_ms, kmeans_predict_ms=predict_ms,
         iteration_trace=dict(
             busy_ms_per_iter=busy / reps / 1e3,
             span_ms_per_iter=span / reps / 1e3,
             idle_share=1.0 - busy / span,
             device_ops_per_iter=len(events) / reps,
             runtime_calls=runtime),
         embedding_argmin_agreement=agree, launches=launches)
    return x, c, ops, launches, predict_ms


def small_fit_matches_cpu(res, dev):
    """The whole fit on the card against the same fit on the CPU (the
    plain versions) from the same centroids: identical labels and n_iter."""
    import torch

    from raft_tpu_torch.cluster import kmeans as tk

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    x = blobs(gen, dev, 4000, 16, 12, spread=0.5, box=6.0)
    c0 = x[:12].clone()
    p = tk.KMeansParams(n_clusters=12, max_iter=30, init=tk.KMeansInit.ARRAY)
    c, _, lab, it = tk.kmeans_fit(res, p, x, c0)
    cc, _, lab_cpu, it_cpu = tk.kmeans_fit(None, p, x.cpu(), c0.cpu())
    check(it == it_cpu, f"small fit: n_iter {it} on card vs {it_cpu} on CPU")
    check(torch.equal(lab.cpu(), lab_cpu), "small fit: labels differ")
    err = float((c.cpu() - cc).abs().max())
    check(err <= 1e-4, f"small fit: centroids differ by {err}")
    emit("small_fit_vs_cpu", shape=[4000, 16], n_clusters=12, n_iter=it,
         centroid_max_abs_err=err)


# ---------------------------------------------------------------------------
# phase 5: pairwise_distance, BASELINE config 1
# ---------------------------------------------------------------------------


def pairwise_phase(res, dev):
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.distance import DistanceType, pairwise_distance

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = blobs(gen, dev, PAIRWISE_M, PAIRWISE_K, 10)
    xn = (x.double() ** 2).sum(1)
    out = {}
    for name in ("L2Expanded", "L2SqrtExpanded", "CosineExpanded",
                 "CorrelationExpanded", "InnerProduct"):
        metric = DistanceType[name]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        got = pairwise_distance(res, x, metric=metric)
        torch.cuda.synchronize()
        launches = {n: c for n, c in kernels.launch_counts().items() if c}
        check(launches == {"pairwise_tile": 1},
              f"pairwise_distance {name}: launches {launches}, want one "
              "pairwise_tile")
        ms = cuda_ms(lambda: pairwise_distance(res, x, metric=metric), 5)
        want = pairwise_distance(None, x.cpu(), metric=metric)
        if name == "L2Expanded":
            scale = xn[:, None] + xn[None, :]
        elif name == "L2SqrtExpanded":
            scale = (xn[:, None] + xn[None, :]).sqrt() / REL ** 0.5
        elif name == "InnerProduct":
            scale = (xn[:, None] * xn[None, :]).sqrt()
        else:
            scale = torch.ones_like(xn[:, None] * xn[None, :])
        err = (got.cpu().double() - want.double()).abs()
        check(bool((err <= REL * scale.cpu() + 1e-5).all()),
              f"pairwise_distance {name}: max err {float(err.max())}")
        if name != "InnerProduct":
            check(bool((got.diagonal() == 0).all()), f"{name}: diagonal")
        out[name] = {"ms": ms, "max_abs_err": float(err.max()),
                     "launches": launches}
    emit("pairwise_distance", shape=[PAIRWISE_M, PAIRWISE_K], tier="high",
         metrics=out)


# ---------------------------------------------------------------------------
# phase 6: per-kernel numbers at the main-path shapes
# ---------------------------------------------------------------------------


def bound(tier, m, n, k, out_bytes, extra_f32_ops=0):
    """The least time (ms) the card could take for a contraction of x [m, k]
    against y [n, k] at ``tier``: every input read once and every output
    written once at the HBM rate, or the products at the peak rate for
    their type (bf16 tensor cores; f32 outside them for 'highest'),
    whichever is larger. Returns ``(ms, "bytes" | "operations")``."""
    in_bytes = 4 * (m * k + n * k + m + n)      # f32 rows or bf16 halves
    passes = {"default": 1, "high": 3, "highest": 1}[tier]
    peak = PEAK_F32_FLOPS if tier == "highest" else PEAK_BF16_FLOPS
    t_ops = (passes * 2 * m * n * k / peak
             + extra_f32_ops / PEAK_F32_FLOPS) * 1e3
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "bytes" if t_bytes > t_ops else "operations"


# ---------------------------------------------------------------------------
# phase 3b: the selection kernels against their plain versions
# ---------------------------------------------------------------------------


def topk_lists_agree(got, want, dist_rows, scale, rel, what):
    """Two top-k results ``(vals [m, k], idx [m, k])`` agree: the same
    empty slots (+inf, 0); indices equal except at near-ties, where the
    plain distances (``dist_rows(rows)`` gives [len(rows), n]) of the
    two columns lie within rel * scale of the row; values within that
    band where finite. Returns (differing positions, max abs error)."""
    import torch

    gv, gi = got
    wv, wi = want
    fin = torch.isfinite(wv)
    check(torch.equal(fin, torch.isfinite(gv)), f"{what}: empty slots differ")
    check(torch.equal(gi[~fin], wi[~fin]) and bool((gi[~fin] == 0).all()),
          f"{what}: empty slots not (+inf, 0)")
    bad = torch.nonzero(gi != wi)
    check(bad.shape[0] <= max(1, gi.numel() // 100),
          f"{what}: {bad.shape[0]} of {gi.numel()} indices differ")
    if bad.shape[0]:
        rows = bad[:, 0]
        d = dist_rows(rows)
        at = torch.arange(rows.numel(), device=d.device)
        gap = (d[at, gi[rows, bad[:, 1]].long()]
               - d[at, wi[rows, bad[:, 1]].long()]).abs()
        check(bool((gap <= rel * scale[rows]).all()),
              f"{what}: indices differ outside the tie band")
    err = (gv - wv).abs()[fin]
    band = (rel * scale[:, None] + 1e-6).expand_as(gv)[fin]
    check(bool((err <= band).all()), f"{what}: values off by "
          f"{float(err.max()) if err.numel() else 0.0}")
    return int(bad.shape[0]), float(err.max()) if err.numel() else 0.0


def exact_equal(got, want, what):
    """Outputs equal bit for bit: floats by their bits, integers (any
    width or sign) as int64."""
    import torch

    for a, b in zip(got, want):
        if a.is_floating_point():
            a, b = a.float().view(torch.int32), b.float().view(torch.int32)
        else:
            a, b = a.to(torch.int64), b.to(torch.int64)
        check(a.shape == b.shape and torch.equal(a, b),
              f"{what}: kernel differs from plain")


def topk_parity(dev):
    """The four selection kernels against their plain versions on the
    card at ragged shapes: ties (the smaller index wins), NaN and +-inf
    rows, rows with fewer than k candidates; the fused top-k at all
    three tiers and metrics; the radix kernels at k = 1, k = len, an
    all-equal row, a threshold inside a tie run, and every dtype."""
    import torch

    from raft_tpu_torch.linalg import contractions as tc
    from raft_tpu_torch.matrix import _topk_order
    from raft_tpu_torch.matrix import radix_select as trs
    from raft_tpu_torch.matrix import topk_insert as tti
    from raft_tpu_torch.neighbors import fused_topk as tft

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    out = {"fused_topk": 0.0, "topk_insert": 0.0, "radix_threshold": 0.0,
           "radix_emit": 0.0}
    mismatches = 0
    # fused top-k: 517 queries, 3001 rows (24 row tiles, one a split)
    m, n, kd = 517, 3001, 45
    x = torch.randn(m, kd, generator=gen, device=dev)
    y = torch.randn(n, kd, generator=gen, device=dev)
    y[2900] = y[17]                             # tied column pair ...
    x[0] = y[17] + 1e-3                         # ... nearest for query 0
    x[5] = float("nan")                         # no candidate at all
    y[40] = float("nan")                        # never a candidate
    xn64 = (x.double() ** 2).nansum(1)
    yn64 = (y.double() ** 2).nansum(1)
    scales = {"l2": (xn64 + yn64.max()).float(),
              "cosine": torch.ones(m, device=dev),
              "inner": (xn64 * yn64.max()).sqrt().float()}
    for tier in ("default", "high", "highest"):
        xs, ys = tc._side(x, tier), tc._side(y, tier)
        for metric in ("l2", "cosine", "inner"):
            for k, nn in ((1, n), (64, n), (256, n), (256, 100)):
                what = f"fused_topk {tier} {metric} k={k} n={nn}"
                yss = side_rows(ys, slice(0, nn))
                got = tft._fused_topk(tier, metric, xs, yss, m, nn, kd, k)
                again = tft._fused_topk(tier, metric, xs, yss, m, nn, kd, k)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"{what}: two runs differ")
                want = tft._fused_topk_plain(tier, metric, xs, yss, m, nn,
                                             kd, k)
                bad, err = topk_lists_agree(
                    got, want, plain_rows(tier, metric, xs, yss, nn, kd),
                    scales[metric], REL, what)
                mismatches += bad
                out["fused_topk"] = max(out["fused_topk"], err)
                check(got[1][5].tolist() == [0] * k, f"{what}: NaN row")
                if nn == 100:
                    check(bool(torch.isinf(got[0][:, 99:]).all()),
                          f"{what}: rows past n not empty")
                if metric == "l2" and k > 1 and nn == n:
                    check(got[1][0, :2].tolist() == [17, 2900],
                          f"{what}: tie not in column order")

    # insertion over a materialised matrix
    v = torch.randn(77, 5003, generator=gen, device=dev)
    v[:, 1000:1100] = v[:, 7:8]                 # ties
    v[3] = float("nan")
    v[6, ::2] = float("-inf")
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for select_min in (True, False):
            vv = v.clone()
            vv[4, :-10] = float("inf") if select_min else float("-inf")
            vv[5] = torch.sort(vv[5], descending=select_min).values
            vv = vv.to(dtype)
            for k in (1, 64, 256):
                exact_equal(tti._topk_insert(vv, k, select_min),
                            tti._insert_plain(vv, k, select_min),
                            f"topk_insert {dtype} min={select_min} k={k}")

    # radix threshold + emit, on sortable keys of every ported dtype
    rows = {}
    base = torch.randn(6, 300001, generator=gen, device=dev)
    base[1, 50:5000] = -3.0                     # a long tie run
    base[2] = 1.0                               # all equal
    base[3, ::3] = float("nan")
    base[4, ::2] = float("inf")
    ints = torch.randint(-100, 100, (6, 300001), generator=gen, device=dev)
    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.int8,
                  torch.int16, torch.int32, torch.uint8, torch.uint16,
                  torch.uint32):
        if dtype.is_floating_point:
            vals = base.to(dtype)
        elif dtype in (torch.uint8, torch.uint16, torch.uint32):
            vals = (ints + 100).to(dtype)
        else:
            vals = ints.to(dtype)
        for select_min in (True, False):
            keys = trs._to_key(vals, select_min)
            for k in (1, 77, 4096, keys.shape[1]):
                what = f"radix {dtype} min={select_min} k={k}"
                t, ntie = trs._radix_threshold(keys, k)
                exact_equal((t, ntie), trs._threshold_plain(keys, k), what)
                exact_equal((trs._radix_emit(keys, t, ntie, k),),
                            (trs._emit_plain(keys, t, ntie, k),), what)
            got = trs.radix_select_k(vals, 77, select_min)
            want = _topk_order.topk(vals, 77, largest=not select_min)
            exact_equal(got, want, f"radix_select_k {dtype}")
        rows[str(dtype)] = "pass"
    # many short rows: one block a row, as on the kNN radix route
    keys = trs._to_key(torch.randn(700, 5000, generator=gen, device=dev),
                       True)
    for k in (1, 1000, 5000):
        t, ntie = trs._radix_threshold(keys, k)
        exact_equal((t, ntie, trs._radix_emit(keys, t, ntie, k)),
                    trs._threshold_plain(keys, k)
                    + (trs._emit_plain(keys, t, ntie, k),), "radix 700 rows")
    emit("topk_parity", fused_topk_shape=[m, n, kd],
         fused_topk_ks=[1, 64, 256], tiers=["default", "high", "highest"],
         metrics=["l2", "cosine", "inner"], insert_shape=[77, 5003],
         radix_shapes=[[6, 300001], [700, 5000]], radix_dtypes=rows,
         near_tie_index_mismatches=mismatches, max_abs_err=out,
         tolerance=f"fused_topk: indices equal except where the plain "
                   f"distances lie within {REL} x (|x|^2 + max|y|^2) (l2), "
                   f"{REL} (cosine), {REL} x |x| max|y| (inner), values "
                   f"within that band; topk_insert, radix_threshold, "
                   f"radix_emit: bit-exact")
    return out


# ---------------------------------------------------------------------------
# phase 4b: the kNN path
# ---------------------------------------------------------------------------


def knn_path(res, dev):
    """knn at the neighbors/knn_l2 shape on the fused (k = 64, 256) and
    radix (k = 1024) routes: route and launch counts per call, indices
    against an exact f64 search on a sample of queries."""
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.neighbors import knn, knn_plan
    from raft_tpu_torch.util import precision as tprec

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    db = torch.randn(KNN_N, KNN_D, generator=gen, device=dev)
    q = torch.randn(KNN_Q, KNN_D, generator=gen, device=dev)
    sample = torch.randperm(KNN_Q, generator=gen, device=dev)[:KNN_SAMPLE]
    d64 = ((q[sample].double() ** 2).sum(1)[:, None]
           - 2.0 * q[sample].double() @ db.double().T
           + (db.double() ** 2).sum(1)[None, :])
    scale = ((q[sample].double() ** 2).sum(1)
             + (db.double() ** 2).sum(1).max()).float()
    total = {name: 0 for name in kernels.REGISTRY}
    calls = {}
    for k in KNN_KS:
        path, chunk = knn_plan(KNN_Q, KNN_N, k)
        want_path = "fused" if k <= 256 else "radix"
        check(path == want_path, f"knn k={k}: route {path}, want {want_path}")
        n_chunks = -(-KNN_N // chunk) if chunk else 0
        with tprec.scope("high"):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            vals, idx = knn(res, db, q, k)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            ms = cuda_ms(lambda: knn(res, db, q, k), 2)
        want = ({"fused_topk": 1} if path == "fused" else
                {"pairwise_tile": n_chunks, "radix_threshold": n_chunks,
                 "radix_emit": n_chunks})
        check({n_: c for n_, c in counts.items() if c} == want,
              f"knn k={k}: launches {counts}, want {want}")
        for name, c in counts.items():
            total[name] += c
        check(tuple(idx.shape) == (KNN_Q, k) and idx.dtype == torch.int32
              and bool(torch.isfinite(vals).all()), f"knn k={k}: output")
        check(bool((vals[:, 1:] >= vals[:, :-1]).all()),
              f"knn k={k}: not nearest first")
        # exact f64 search on the sample: the returned columns' exact
        # distances, sorted, equal the exact top k within the tie band
        got = d64.gather(1, idx[sample].long())
        best = torch.topk(d64, k, dim=1, largest=False).values
        band = (REL * scale.double())[:, None]
        gap = (torch.sort(got, dim=1).values - best).abs()
        check(bool((gap <= band).all()),
              f"knn k={k}: off the exact top k by {float(gap.max())}")
        err = (vals[sample].double() - got).abs()
        check(bool((err <= band).all()),
              f"knn k={k}: distances off by {float(err.max())}")
        exact_rows = int((torch.sort(idx[sample].long(), 1).values == torch.sort(
            torch.topk(d64, k, dim=1, largest=False).indices, 1).values
        ).all(1).sum())
        calls[k] = dict(route=path, chunk=chunk, wall_s=wall, ms=ms,
                        launches={n_: c for n_, c in counts.items() if c},
                        max_gap_to_exact=float(gap.max()),
                        max_abs_err=float(err.max()),
                        sample_rows_with_exact_set=exact_rows)
        del vals, idx
        torch.cuda.empty_cache()
    emit("knn_path", db=[KNN_N, KNN_D], queries=KNN_Q, metric="l2",
         tier="high", sample_checked=KNN_SAMPLE, calls=calls, launches=total,
         tolerance=f"exact f64 top-k distances within {REL} x (|q|^2 + "
                   "max|x|^2) of the returned columns'")
    return db, q, total, calls


# ---------------------------------------------------------------------------
# phase 4c: the select_k path
# ---------------------------------------------------------------------------


def select_path(res, dev):
    """select_k AUTO (radix) and WARPSORT_FILTERED (insertion) at full
    width, each exactly against the stable key sort on the card."""
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.matrix import SelectAlgo, _topk_order, select_k

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    rr, rc, rk = SELECT_RADIX
    ir, ic, ik = SELECT_INSERT
    v_radix = torch.randn(rr, rc, generator=gen, device=dev)
    v_ins = torch.randn(ir, ic, generator=gen, device=dev)
    v_desc = torch.sort(v_ins, dim=1, descending=True).values
    v_asc = torch.flip(v_desc, dims=(1,))
    cases = (("auto_radix", v_radix, rk, SelectAlgo.AUTO,
              {"radix_threshold": 1, "radix_emit": 1}),
             ("filtered_random", v_ins, ik, SelectAlgo.WARPSORT_FILTERED,
              {"topk_insert": 1}),
             ("filtered_descending", v_desc, ik,
              SelectAlgo.WARPSORT_FILTERED, {"topk_insert": 1}),
             ("filtered_ascending", v_asc, ik,
              SelectAlgo.WARPSORT_FILTERED, {"topk_insert": 1}))
    total = {}
    out = {}
    for name, v, k, algo, want in cases:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        vals, idx = select_k(res, v, k, algo=algo)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n_: c for n_, c in kernels.launch_counts().items() if c}
        check(counts == want, f"select_k {name}: launches {counts}")
        for n_, c in counts.items():
            total[n_] = total.get(n_, 0) + c
        wv, wi = _topk_order.topk(v, k, largest=False)
        check(torch.equal(idx.long(), wi) and torch.equal(vals, wv),
              f"select_k {name}: differs from the stable key sort")
        out[name] = dict(shape=list(v.shape), k=k, algo=algo.name,
                         wall_s=wall, launches=counts,
                         ms=cuda_ms(lambda: select_k(res, v, k, algo=algo),
                                    3))
        del vals, idx, wv, wi
    emit("select_k_path", cases=out, launches=total,
         check="indices and values equal to the stable key sort, exactly")
    return v_radix, v_ins, v_desc, v_asc, total


# ---------------------------------------------------------------------------
# phase 6b: the selection kernels' numbers at their paths' shapes
# ---------------------------------------------------------------------------


def topk_numbers(db, q, v_radix, v_ins, v_desc, v_asc, launches,
                 parity_errs, hgmma):
    """Each selection kernel at its path's shape: held against its plain
    version, timed beside it, beside a one-call PyTorch yardstick (timed
    here only) and beside its bound; the fused top-k at k = 64 and 256 at
    every tier, on the tile its route names, beside the time of its
    operands' preparation. The kNN radix route's chunk is built
    from the path's own data, and pairwise_tile, radix_threshold and
    radix_emit are each held against their plain versions on it. Returns
    the kernels' rows and pairwise_tile's numbers at that chunk."""
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.linalg import contractions as tc
    from raft_tpu_torch.matrix import radix_select as trs
    from raft_tpu_torch.matrix import topk_insert as tti
    from raft_tpu_torch.neighbors import fused_topk as tft
    from raft_tpu_torch.neighbors import knn_plan

    table = []

    def row(name, ms, plain_ms, b, by, library_ms, library_call, err,
            **extra):
        spec = kernels.REGISTRY[name]
        table.append({"name": name, "route": "cuda",
                      "source": f"raft_tpu_torch/{spec.source}",
                      "replaces": spec.replaces, "launches": launches[name],
                      "max_abs_err": max(err, parity_errs[name]), "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                      "library_ms": library_ms,
                      "library_call": library_call, "parity": "pass",
                      **extra})

    with torch.no_grad():
        # fused top-k at the kNN shape, k = 64 and 256, every tier ('high'
        # is the path's)
        nq, n, d = q.shape[0], db.shape[0], db.shape[1]
        scale = ((q[:PLAIN_Q].double() ** 2).sum(1)
                 + (db.double() ** 2).sum(1).max()).float()
        by_tier, operands = {}, {}
        for tier in ("high", "default", "highest"):
            txs, tys = tc._side(q, tier), tc._side(db, tier)
            tpq = side_rows(txs, slice(0, PLAIN_Q))
            if tft.ROUTE[tier] == "wgmma":
                # what each call does before its launch, on the 2^20 rows
                operands[tier] = dict(
                    side_ms=cuda_ms(lambda: tc._side(db, tier), 3),
                    wgmma_operands_ms=cuda_ms(lambda: tc._wgmma_operands(
                        tier, txs, tys, nq, n, d), 3))
            by_k = {}
            for k in (64, 256):
                what = f"fused_topk {tier} k={k} at the kNN shape"
                got = tft._fused_topk(tier, "l2", txs, tys, nq, n, d, k)
                want = tft._fused_topk_plain(tier, "l2", tpq, tys, PLAIN_Q, n,
                                             d, k)
                bad, err = topk_lists_agree(
                    (got[0][:PLAIN_Q], got[1][:PLAIN_Q]), want,
                    plain_rows(tier, "l2", tpq, tys, n, d), scale, REL, what)
                del got, want
                b, by = bound(tier, nq, n, d, 8 * nq * k)
                by_k[k] = dict(
                    ms=cuda_ms(lambda: tft._fused_topk(tier, "l2", txs, tys,
                                                       nq, n, d, k), 2),
                    plain_ms_at_plain_q=cuda_ms(
                        lambda: tft._fused_topk_plain(tier, "l2", tpq, tys,
                                                      PLAIN_Q, n, d, k), 2),
                    bound_ms=b, bound_by=by, differing_indices=bad,
                    max_abs_err=err, tile=tft.ROUTE[tier])
                if tier == "high":
                    by_k[k]["library_ms"] = cuda_ms(
                        lambda: cdist_topk(q, db, k), 1)
                torch.cuda.empty_cache()
            by_tier[tier] = by_k
            if tier == "high":
                xs, ys, pq = txs, tys, tpq
            else:
                del txs, tys, tpq
        # where the time goes: the same tile with a 1-wide epilogue (the
        # fused argmin), and the top-k at smaller k
        breakdown = dict(
            argmin_same_shape_ms=cuda_ms(
                lambda: tc._fused_argmin("high", "l2", xs, ys, nq, n, d), 2),
            topk_ms_by_k={kk: cuda_ms(lambda: tft._fused_topk(
                "high", "l2", xs, ys, nq, n, d, kk), 2) for kk in (1, 16)})
        k64 = by_tier["high"][64]
        row("fused_topk", k64["ms"], k64["plain_ms_at_plain_q"],
            k64["bound_ms"], k64["bound_by"], k64["library_ms"],
            "torch.cdist + torch.topk(largest=False), chunked over 131,072 "
            "database rows, then a merge",
            max(r["max_abs_err"] for bk in by_tier.values()
                for r in bk.values()),
            shape=[nq, n, d], k=64, tier="high", tile=tft.ROUTE["high"],
            hgmma=hgmma["fused_topk"],
            plain_q=PLAIN_Q, plain_note=f"plain version timed at {PLAIN_Q} "
            f"queries (the full [{nq}, {n}] f32 matrix and its sort do not "
            "fit); held against the kernel on those rows",
            differing_indices=k64["differing_indices"],
            k256=by_tier["high"][256],
            other_tiers={t: by_tier[t] for t in ("default", "highest")},
            operands=operands, breakdown=breakdown)
        del ys, pq

        # the kNN radix route's chunk, built from the path's own data as
        # _knn_chunked builds it: the queries against the first chunk of
        # the database at 'high', then the sortable keys of that block
        ck = KNN_KS[-1]
        cw = knn_plan(nq, n, ck)[1]
        cys = tc._side(db[:cw].contiguous(), "high")
        cd = tc._pairwise_tile("high", "l2", xs, cys, nq, cw, d)
        cscale = ((q.double() ** 2).sum(1)
                  + (db[:cw].double() ** 2).sum(1).max()).float()
        cerr = (cd - tc._pairwise_plain("high", "l2", xs, cys, nq, cw,
                                        d)).abs()
        check(bool((cerr <= REL * cscale[:, None] + 1e-6).all()),
              f"pairwise_tile at the kNN chunk: max err {float(cerr.max())}")
        cerr = float(cerr.max())
        ckeys = trs._to_key(cd, True).contiguous()
        ct, cn = trs._radix_threshold(ckeys, ck)
        exact_equal((ct, cn), trs._threshold_plain(ckeys, ck),
                    "radix_threshold at the kNN chunk")
        want = (trs._emit_plain(ckeys, ct, cn, ck),)
        exact_equal((trs._radix_emit(ckeys, ct, cn, ck),), want,
                    "radix_emit at the kNN chunk")
        exact_equal((emit_lookback(ckeys, ct, cn, ck),), want,
                    "radix_emit's look-back form at the kNN chunk")
        del want
        pb, pby = bound("high", nq, cw, d, 4 * nq * cw)
        zkeys = torch.zeros_like(ckeys)     # equal keys: the row's read alone
        knn_chunk = {
            "pairwise_tile": dict(
                shape=[nq, cw, d], tier="high",
                tile=tc.PAIRWISE_ROUTE["high"],
                launches=launches["pairwise_tile"], max_abs_err=cerr,
                ms=cuda_ms(lambda: tc._pairwise_tile("high", "l2", xs, cys,
                                                     nq, cw, d), 5),
                plain_ms=cuda_ms(lambda: tc._pairwise_plain(
                    "high", "l2", xs, cys, nq, cw, d), 3),
                bound_ms=pb, bound_by=pby,
                library_ms=cuda_ms(lambda: torch.cdist(q, db[:cw]), 3)),
            "radix_threshold": dict(
                shape=[nq, cw], k=ck,
                ms=cuda_ms(lambda: trs._radix_threshold(ckeys, ck), 5),
                all_equal_rows_ms=cuda_ms(lambda: trs._radix_threshold(
                    zkeys, ck), 5),
                plain_ms=cuda_ms(lambda: trs._threshold_plain(ckeys, ck), 3),
                bound_ms=(4 * nq * cw + 8 * nq) / PEAK_BYTES * 1e3,
                bound_by="bytes",
                library_ms=cuda_ms(lambda: torch.kthvalue(ckeys, ck, dim=1),
                                   3)),
            "radix_emit": dict(
                shape=[nq, cw], k=ck, form=trs._emit_plan(nq, cw).form,
                ms=cuda_ms(lambda: trs._radix_emit(ckeys, ct, cn, ck), 5),
                lookback_ms=cuda_ms(lambda: emit_lookback(ckeys, ct, cn, ck),
                                    5),
                plain_ms=cuda_ms(lambda: trs._emit_plain(ckeys, ct, cn, ck),
                                 3),
                bound_ms=(4 * nq * cw + 4 * nq * ck) / PEAK_BYTES * 1e3,
                bound_by="bytes",
                library_ms=cuda_ms(lambda: torch.topk(cd, ck, dim=1,
                                                      largest=False), 3))}
        del xs, cys, cd, ckeys, zkeys, ct, cn
        torch.cuda.empty_cache()

        # insertion select at the WARPSORT_FILTERED shape
        ir, ic, ik = v_ins.shape[0], v_ins.shape[1], SELECT_INSERT[2]
        for v, what in ((v_ins, "random"), (v_desc, "descending"),
                        (v_asc, "ascending")):
            exact_equal(tti._topk_insert(v, ik, True),
                        tti._insert_plain(v, ik, True),
                        f"topk_insert {what} at the select shape")
        t_bytes = (4 * ir * ic + 8 * ir * ik) / PEAK_BYTES * 1e3
        row("topk_insert", cuda_ms(lambda: tti._topk_insert(v_ins, ik, True),
                                   5),
            cuda_ms(lambda: tti._insert_plain(v_ins, ik, True), 3),
            t_bytes, "bytes",
            cuda_ms(lambda: torch.topk(v_ins, ik, largest=False), 5),
            "torch.topk(v, k, largest=False)", 0.0, shape=[ir, ic], k=ik,
            descending_rows_ms=cuda_ms(
                lambda: tti._topk_insert(v_desc, ik, True), 5),
            descending_rows_library_ms=cuda_ms(
                lambda: torch.topk(v_desc, ik, largest=False), 5),
            ascending_rows_ms=cuda_ms(
                lambda: tti._topk_insert(v_asc, ik, True), 5),
            ascending_rows_library_ms=cuda_ms(
                lambda: torch.topk(v_asc, ik, largest=False), 5))

        # radix threshold and emit at the select_k_bars shape; the kNN
        # chunk's numbers (above) go beside them
        rr, rc, rk = SELECT_RADIX
        keys = trs._to_key(v_radix, True)
        t, ntie = trs._radix_threshold(keys, rk)
        exact_equal((t, ntie), trs._threshold_plain(keys, rk),
                    "radix_threshold at the select shape")
        exact_equal((trs._radix_emit(keys, t, ntie, rk),),
                    (trs._emit_plain(keys, t, ntie, rk),),
                    "radix_emit at the select shape")
        key_bytes = 4 * rr * rc
        row("radix_threshold",
            cuda_ms(lambda: trs._radix_threshold(keys, rk), 5),
            cuda_ms(lambda: trs._threshold_plain(keys, rk), 3),
            (key_bytes + 8 * rr) / PEAK_BYTES * 1e3, "bytes",
            cuda_ms(lambda: torch.kthvalue(keys, rk, dim=1), 3),
            "torch.kthvalue(keys, k, dim=1)", 0.0, shape=[rr, rc], k=rk,
            knn_chunk_shape=knn_chunk["radix_threshold"])
        # sorted and reverse-sorted rows: every winner in the first or the
        # last split of a row
        ordered = {}
        for what, desc in (("sorted", False), ("reversed", True)):
            okeys = trs._to_key(torch.sort(v_radix, dim=1,
                                           descending=desc).values, True)
            ot, on = trs._radix_threshold(okeys, rk)
            exact_equal((trs._radix_emit(okeys, ot, on, rk),),
                        (trs._emit_plain(okeys, ot, on, rk),),
                        f"radix_emit at the select shape, {what} rows")
            ordered[f"{what}_rows_ms"] = cuda_ms(
                lambda: trs._radix_emit(okeys, ot, on, rk), 5)
            del okeys, ot, on
        row("radix_emit", cuda_ms(lambda: trs._radix_emit(keys, t, ntie, rk),
                                  5),
            cuda_ms(lambda: trs._emit_plain(keys, t, ntie, rk), 3),
            (key_bytes + 4 * rr * rk) / PEAK_BYTES * 1e3, "bytes",
            cuda_ms(lambda: torch.topk(v_radix, rk, largest=False), 3),
            "torch.topk(v, k, largest=False): threshold and emission "
            "together", 0.0, shape=[rr, rc], k=rk,
            form=trs._emit_plan(rr, rc).form, **ordered,
            knn_chunk_shape=knn_chunk["radix_emit"])
    return table, knn_chunk["pairwise_tile"]


def emit_lookback(keys, t, ntie, k):
    """radix_emit's look-back form on keys where the plan picks the walk
    (a split a chunk of EMIT_CHUNK keys, as at the select shape): the
    number that keeps the walk, timed beside it at the kNN chunks and
    held to the plain version there. Its launches count in no path's
    row."""
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.matrix import radix_select as trs

    rows, n = keys.shape
    splits = -(-n // trs.EMIT_CHUNK)
    scratch = torch.empty(8 * rows * splits + 4 * rows, dtype=torch.uint8,
                          device=keys.device)
    out = torch.empty((rows, k), dtype=torch.int32, device=keys.device)
    kernels.launch("radix_emit", keys.device, keys.data_ptr(),
                   keys.stride(0), rows, n, k, t.data_ptr(), ntie.data_ptr(),
                   splits, scratch.data_ptr(), out.data_ptr())
    return out


def knn_k_sweep(db, q):
    """The kNN dispatch bands on the card: at the kNN shape, 'high', the
    fused route (knn_fused) against the radix route (_knn_chunked over
    the k = 1024 plan's chunks) at k = 16, 64, 128 and 256, each held to
    the other (indices equal but at near-ties, values within the band).
    The bands themselves stay the reference's (knn_plan)."""
    import torch

    from raft_tpu_torch.linalg import contractions as tc
    from raft_tpu_torch.neighbors import brute_force as tbf
    from raft_tpu_torch.neighbors import fused_topk as tft
    from raft_tpu_torch.util import precision as tprec

    nq, n, d = q.shape[0], db.shape[0], db.shape[1]
    chunk = tbf.knn_plan(nq, n, KNN_KS[-1])[1]
    scale = ((q.double() ** 2).sum(1) + (db.double() ** 2).sum(1).max()
             ).float()
    xs, ys = tc._side(q, "high"), tc._side(db, "high")
    out = {}
    with tprec.scope("high"), torch.no_grad():
        for k in (16, 64, 128, 256):
            fused = tft.knn_fused(q, db, k)
            radix = tbf._knn_chunked(q, db, k, chunk, "l2")
            bad, _ = topk_lists_agree(
                fused, radix, lambda r: tc._pairwise_plain(
                    "high", "l2", side_rows(xs, r), ys, r.numel(), n, d),
                scale, REL, f"knn k={k}: fused vs radix route")
            del fused, radix
            out[k] = dict(
                fused_ms=cuda_ms(lambda: tft.knn_fused(q, db, k), 2),
                radix_ms=cuda_ms(lambda: tbf._knn_chunked(q, db, k, chunk,
                                                          "l2"), 1),
                differing_indices=bad,
                plan_route=tbf.knn_plan(nq, n, k)[0])
            torch.cuda.empty_cache()
    emit("knn_k_sweep", shape=[nq, n, d], tier="high", radix_chunk=chunk,
         by_k=out, tolerance=f"indices equal but where the plain distances "
         f"lie within {REL} x (|q|^2 + max|x|^2), values within that band")
    return out


def cdist_topk(q, db, k, rows=131072):
    """The library yardstick of the fused top-k: cdist and topk over
    database chunks, then a topk over the pooled candidates."""
    import torch

    pv, pi = [], []
    for off in range(0, db.shape[0], rows):
        v, i = torch.topk(torch.cdist(q, db[off:off + rows]), k, dim=1,
                          largest=False)
        pv.append(v)
        pi.append(i + off)
    v, i = torch.topk(torch.cat(pv, 1), k, dim=1, largest=False)
    return v, torch.gather(torch.cat(pi, 1), 1, i)


CDIST_ROWS = 65536
CANDIDATES = 10240     # k-means||'s candidates at config 3: about 10 k
# BASELINE config 5's Lloyd shape: 10M x 256, k = 4096 (planned, not run)
CONFIG5_LLOYD = (10_000_000, 4096, 256)


def device_trace(fn, reps):
    """``reps`` calls of ``fn()`` (after one warm-up) under torch.profiler:
    the card's kernels and copies as ``(name, start_us, end_us)``, and the
    host's CUDA runtime calls counted by name (the trace's closing
    ``cudaDeviceSynchronize`` among them)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device, runtime = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            device.append((e.name, e.time_range.start, e.time_range.end))
        elif e.name.startswith("cuda"):
            runtime[e.name] = runtime.get(e.name, 0) + 1
    check(bool(device), "torch.profiler saw no work on the card")
    return device, runtime


def busy_us(events):
    """Microseconds in which at least one of ``events`` ran."""
    total, end = 0.0, float("-inf")
    for _, s, e in sorted(events, key=lambda ev: ev[1]):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def call_breakdown(fn, reps, kernel):
    """One call of ``fn`` on the card's clock, from a trace of ``reps``
    calls, ms: kernels whose name holds ``kernel`` (``kernel_ms``), all
    its device work (``busy_ms``), and its first device op to its last
    (``span_ms``: busy time plus the card's wait on the host)."""
    events, _ = device_trace(fn, reps)
    own = sum(e - s for name, s, e in events if kernel in name)
    span = max(e for _, _, e in events) - min(s for _, s, _ in events)
    return dict(kernel_ms=own / reps / 1e3,
                busy_ms=busy_us(events) / reps / 1e3,
                span_ms=span / reps / 1e3)


def lloyd_split(c, ops, m):
    """The tier-'high' Lloyd pass at the main shape split into its argmin
    and its sums (the counting sort, the segment sums, the fix-up): device
    ms a pass, summed by kernel name from a trace of three passes."""
    from raft_tpu_torch.linalg import contractions as tc

    reps = 3
    events, _ = device_trace(lambda: tc.fused_lloyd_prepared(ops, c, m=m),
                             reps)
    argmin = [ev for ev in events if "lloyd_argmin" in ev[0]]
    sums = [ev for ev in events
            if "lloyd_" in ev[0] and "lloyd_argmin" not in ev[0]]
    check(len(argmin) == reps and len(sums) >= 5 * reps,
          f"Lloyd trace: {len(argmin)} argmin and {len(sums)} sums kernels "
          f"in {reps} passes")
    return dict(argmin_ms=sum(e - s for _, s, e in argmin) / reps / 1e3,
                sums_ms=sum(e - s for _, s, e in sums) / reps / 1e3)


def lloyd_plan_phase(dev):
    """The Lloyd pass's plan (argmin grid, row chunks, scratch) at the
    main shape and at BASELINE config 5's (10M x 256, k = 4096): worked
    out by the wrapper's planner, not launched."""
    import torch

    from raft_tpu_torch.linalg import contractions as tc

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    emit("lloyd_plan", multiprocessors=sms, **{
        what: dict(zip(("m", "n", "k"), shape),
                   **tc._lloyd_plan(*shape, sms)._asdict())
        for what, shape in (("main", (MAIN_M, MAIN_N, MAIN_K)),
                            ("config5", CONFIG5_LLOYD))})


def topk_plan_phase(dev):
    """The fused top-k's split plan (splits, units, grid, scratch) at the
    kNN shape for k = 64 and 256 and for the probe (k = 1): worked out by
    the wrapper's planner from the shape and the card's multiprocessors,
    not measured."""
    import torch

    from raft_tpu_torch.neighbors import fused_topk as tft

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    emit("topk_plan", multiprocessors=sms, shape=[KNN_Q, KNN_N], **{
        f"k{k}": tft._split_plan(KNN_Q, KNN_N, k, sms)._asdict()
        for k in (1, 64, 256)})


def argmin_plan_phase(dev):
    """The fused argmin's wgmma plan (walk, fold form, splits, units,
    grid, scratch) at the shapes the kernels line times it: config 3, the
    k-means|| candidate shape, the kNN shape and the spectral
    partition's: worked out by the wrapper's planner from the shapes and
    the card's multiprocessors, not measured."""
    import torch

    from raft_tpu_torch.linalg import contractions as tc

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    emit("argmin_plan", multiprocessors=sms, **{
        what: dict(m=m, n=n, **tc._argmin_plan(m, n, sms)._asdict())
        for what, (m, n) in (
            ("main", (MAIN_M, MAIN_N)), ("candidates", (MAIN_M, CANDIDATES)),
            ("knn", (KNN_Q, KNN_N)),
            ("partition", (1 << RMAT_SCALE, PLANTED_BLOCKS)))})


def radix_plan_phase():
    """radix_threshold's plan (form, splits, span, candidate buffer, global
    scratch and shared memory; a ``radix_plan`` line) and radix_emit's
    (form, splits, span, scratch; an ``emit_plan`` line) at the shapes the
    paths give them: the kNN radix routes' 4096 x 32,768 chunks, the
    256-query linf / canberra chunks and the select shape: worked out by
    the wrappers' planners from the shapes, not measured."""
    import torch

    from raft_tpu_torch.matrix import radix_select as trs
    from raft_tpu_torch.neighbors import knn_plan

    shapes = {"knn_chunk": (KNN_Q, knn_plan(KNN_Q, KNN_N, KNN_KS[-1])[1]),
              "knn_l1_chunk": (KNN_Q, knn_plan(KNN_Q, KNN_N, UNEXP_K,
                                               "l1")[1]),
              "knn_256_query_chunk": (UNEXP_Q, knn_plan(
                  UNEXP_Q, KNN_N, UNEXP_K, "linf")[1]),
              "select": SELECT_RADIX[:2]}
    optin = trs._smem_optin(torch.device("cuda:0"))
    emit("radix_plan", smem_optin=optin,
         row_keys_max=trs._row_keys_max(optin), **{
             what: dict(rows=r, cols=c,
                        **trs._threshold_plan(r, c, optin)._asdict())
             for what, (r, c) in shapes.items()})
    emit("emit_plan", chunk=trs.EMIT_CHUNK,
         target_blocks=trs.TARGET_BLOCKS, **{
             what: dict(rows=r, cols=c, **trs._emit_plan(r, c)._asdict())
             for what, (r, c) in shapes.items()})


def cdist_argmin(x, y, rows=CDIST_ROWS):
    """The library yardstick of the fused argmin at many centroids:
    torch.cdist over row chunks of x, then argmin."""
    import torch

    return torch.cat([torch.cdist(x[off:off + rows], y).argmin(1)
                      for off in range(0, x.shape[0], rows)])


def argmin_scale(metric, xs, ys, rows):
    """Per-row magnitude of the fused argmin's distances: |x|^2 + max|y|^2
    (l2), 1 (cosine), |x| max|y| (inner)."""
    import torch

    xn, yn = xs.norms[:rows].double(), ys.norms.double().max()
    if metric == "l2":
        return (xn + yn).float()
    if metric == "cosine":
        return torch.ones(rows, device=xs.v0.device)
    return (xn * yn).sqrt().float()


def argmin_shape(tier, metric, xs, ys, m, n, k, plain_at, library,
                 library_call, reps):
    """fused_argmin at one shape: held against its plain version on the
    first ``plain_at`` rows (labels equal but at near-ties, values within
    REL of the row's scale); timed beside the plain version (at those
    rows), the library call (timed here only) and the bound. On the wgmma
    route the row names the plan's walk and fold form (argmin_plan line
    for the rest of the plan)."""
    import torch

    from raft_tpu_torch.linalg import contractions as tc

    what = f"fused_argmin {tier} {metric} at {m} x {n} x {k}"
    got = tc._fused_argmin(tier, metric, xs, ys, m, n, k)
    pr = min(m, plain_at)
    pxs = side_rows(xs, slice(0, pr))
    want = tc._argmin_plain(tier, metric, pxs, ys, pr, n, k)
    scale = argmin_scale(metric, xs, ys, pr)
    bad = labels_agree(got[1][:pr], want[1], plain_rows(tier, metric, pxs,
                                                        ys, n, k),
                       scale, REL, what)
    same = got[1][:pr] == want[1]
    err = (got[0][:pr] - want[0]).abs()[same]
    check(bool((err <= REL * scale[same] + 1e-6).all()),
          f"{what}: values off the plain version by {float(err.max())}")
    out = dict(shape=[m, n, k], tier=tier, metric=metric,
               tile=tc.ARGMIN_ROUTE[tier], plain_rows=pr,
               differing_labels=int(bad.numel()),
               max_abs_err=float(err.max()) if err.numel() else 0.0)
    if tc.ARGMIN_ROUTE[tier] == "wgmma":
        plan = tc._argmin_plan(m, n, torch.cuda.get_device_properties(
            xs.v0.device).multi_processor_count)
        out.update(walk=plan.walk, fold=plan.fold)
    del got, want, bad, same, err
    out["ms"] = cuda_ms(lambda: tc._fused_argmin(tier, metric, xs, ys, m, n,
                                                 k), reps)
    out["plain_ms"] = cuda_ms(lambda: tc._argmin_plain(tier, metric, pxs, ys,
                                                       pr, n, k), 2)
    out["bound_ms"], out["bound_by"] = bound(tier, m, n, k, 8 * m)
    if library is not None:
        out["library_ms"] = cuda_ms(library, 1)
        out["library_call"] = library_call
    torch.cuda.empty_cache()
    return out


def kernel_numbers(x, c, ops, parity_errs, launches, predict_ms, hgmma):
    """Each kernel at the main-path shapes, at every tier: held against
    its plain version, then timed beside it, beside a one-call PyTorch
    yardstick (timed here only; the port never calls it) and beside its
    bound. The main path's tier ('high') fills the kernel's row. The fused
    argmin's row adds its tile, walk and fold form at each tier, cosine and
    inner, kmeans_predict's time and the k-means|| candidate shape."""
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.linalg import contractions as tc

    m, k = x.shape
    n = c.shape[0]
    dscale = ((x.double() ** 2).sum(1) + (c.double() ** 2).sum(1).max()
              ).float()                          # |x|^2 + |y|^2 per row
    cases = {
        "pairwise_tile": dict(
            run=lambda t, xs, ys: (tc._pairwise_tile(t, "l2", xs, ys, m, n,
                                                     k),),
            plain=lambda t, xs, ys: (tc._pairwise_plain(t, "l2", xs, ys, m,
                                                        n, k),),
            out_bytes=4 * m * n, extra=0,
            library=lambda: torch.cdist(x, c),
            library_call="torch.cdist(x, c): rooted L2 in f32"),
        "fused_argmin": dict(
            run=lambda t, xs, ys: tc._fused_argmin(t, "l2", xs, ys, m, n, k),
            plain=lambda t, xs, ys: tc._argmin_plain(t, "l2", xs, ys, m, n,
                                                     k),
            out_bytes=8 * m, extra=0,
            library=lambda: torch.cdist(x, c).argmin(1),
            library_call="torch.cdist(x, c).argmin(1)"),
        "fused_lloyd": dict(
            run=lambda t, xs, ys: tc._fused_lloyd(t, xs, ys, m, n, k),
            plain=lambda t, xs, ys: tc._lloyd_plain(t, xs, ys, m, n, k),
            out_bytes=4 * n * k + 4 * n + 8 * m, extra=2 * m * k,
            library=None, library_call=None),
    }
    table = []
    with torch.no_grad():
        for name, case in cases.items():
            by_tier = {}
            for tier in ("high", "default", "highest"):
                xs = (tc.Side(ops[0], ops[1], ops[2].reshape(-1))
                      if tier == "high" else tc._side(x, tier))
                ys = tc._side(c, tier)
                got = case["run"](tier, xs, ys)
                want = case["plain"](tier, xs, ys)
                if name == "pairwise_tile":
                    err = (got[0] - want[0]).abs()
                    check(bool((err <= REL * dscale[:, None] + 1e-6).all()),
                          f"{name} {tier} at main shape: max err "
                          f"{float(err.max())}")
                    rel_err = float((err / dscale[:, None]).max())
                    agree = None
                else:
                    what = f"{name} {tier} at main shape"
                    bad = labels_agree(got[-1], want[-1],
                                       plain_rows(tier, "l2", xs, ys, n, k),
                                       dscale, REL, what)
                    agree = 1.0 - bad.numel() / m
                    same = got[-1] == want[-1]
                    err = (got[-2] - want[-2]).abs()[same]
                    check(bool((err <= REL * dscale[same] + 1e-6).all()),
                          f"{what}: distance error")
                    rel_err = float((err / dscale[same]).max())
                max_err = float(err.max())
                sums_rel = None
                if name == "fused_lloyd":
                    check(float(got[1].sum()) == m, "lloyd counts")
                    sums_err, sums_rel = check_lloyd_sums(
                        tier, xs, got, want, m, n, k, what)
                    max_err = max(max_err, sums_err)
                del got, want, err
                b, by = bound(tier, m, n, k, case["out_bytes"],
                              case["extra"])
                by_tier[tier] = dict(
                    ms=cuda_ms(lambda: case["run"](tier, xs, ys), 3),
                    plain_ms=cuda_ms(lambda: case["plain"](tier, xs, ys), 3),
                    bound_ms=b, bound_by=by, max_abs_err=max_err,
                    max_err_over_norms=rel_err,
                    label_agreement=agree, differing_labels=(
                        None if agree is None else bad.numel()),
                    sums_err_over_mass=sums_rel)
                torch.cuda.empty_cache()
            if name == "pairwise_tile":
                for tier, row in by_tier.items():
                    row["tile"] = tc.PAIRWISE_ROUTE[tier]
            if name == "fused_lloyd":
                by_tier["high"].update(lloyd_split(c, ops, m))
            high = by_tier["high"]
            spec = kernels.REGISTRY[name]
            table.append({
                "name": name, "route": "cuda",
                "source": f"raft_tpu_torch/{spec.source}",
                "replaces": spec.replaces, "launches": launches[name],
                "max_abs_err": max(high["max_abs_err"], parity_errs[name]),
                "max_err_over_norms": high["max_err_over_norms"],
                "ms": high["ms"], "plain_ms": high["plain_ms"],
                "bound_ms": high["bound_ms"], "bound_by": high["bound_by"],
                "library_ms": (None if case["library"] is None
                               else cuda_ms(case["library"], 3)),
                "library_call": case["library_call"], "parity": "pass",
                "differing_labels": high["differing_labels"],
                "sums_err_over_mass": high["sums_err_over_mass"],
                "shape": [m, n, k], "tier": "high",
                **({"tile": by_tier["high"]["tile"]}
                   if name == "pairwise_tile" else {}),
                **({k_: high[k_] for k_ in ("argmin_ms", "sums_ms")}
                   if name == "fused_lloyd" else {}),
                "other_tiers": {t: by_tier[t] for t in ("default",
                                                        "highest")}})

        # the fused argmin: its tile, walk and fold form at each tier, the
        # other metrics at this shape, kmeans_predict, and the
        # k-means|| candidate weighting (~10k candidates against X); the
        # plain version at the first CDIST_ROWS rows (at all m rows it
        # needs m x n f32 three times)
        arow = table[1]
        xs = tc.Side(ops[0], ops[1], ops[2].reshape(-1))
        ys = tc._side(c, "high")
        for tier, row in arow["other_tiers"].items():
            row["tile"] = tc.ARGMIN_ROUTE[tier]
        arow["tile"] = tc.ARGMIN_ROUTE["high"]
        arow["hgmma"] = hgmma["fused_argmin"]
        arow["kmeans_predict_ms"] = predict_ms
        arow["by_metric"] = {}
        for tier, metric in (("high", "l2"), ("high", "cosine"),
                             ("high", "inner"), ("default", "l2")):
            arow["by_metric"][f"{tier} {metric}"] = argmin_shape(
                tier, metric, xs if tier == "high" else tc._side(x, tier),
                ys if tier == "high" else tc._side(c, tier), m, n, k,
                CDIST_ROWS,
                (lambda: torch.cdist(x, c).argmin(1)) if metric == "l2"
                else None, "torch.cdist(x, c).argmin(1)", 5)
        for tier, row in (("high", arow),
                          ("default", arow["other_tiers"]["default"])):
            row.update({f: arow["by_metric"][f"{tier} l2"][f]
                        for f in ("walk", "fold")})
        n2 = CANDIDATES
        cand = x[torch.randperm(m, device=x.device)[:n2]]
        arow["candidate_shape"] = argmin_shape(
            "high", "l2", xs, tc._side(cand, "high"), m, n2, k, CDIST_ROWS,
            lambda: cdist_argmin(x, cand),
            f"torch.cdist(x_chunk, y).argmin(1) over chunks of {CDIST_ROWS} "
            "rows", 2)
    return table


# ---------------------------------------------------------------------------
# phase 7: the sparse kernels against their plain versions
# ---------------------------------------------------------------------------


def make_csr(gen, dev, n_rows, n_cols, max_len=20, empty_frac=0.3,
             hubs=(), pad=0, dtype=None):
    """A random CSR on the card: ``(indptr, indices, data)``, int32
    indices. Rows of 0..max_len entries, ``empty_frac`` of them empty;
    ``hubs`` is a list of ``(row, length)``; ``pad`` physical entries past
    indptr[-1] carry NaN data, which the kernels must never read."""
    import torch

    dtype = dtype or torch.float32
    lengths = torch.randint(0, max_len + 1, (n_rows,), generator=gen,
                            device=dev)
    lengths[torch.rand(n_rows, generator=gen, device=dev) < empty_frac] = 0
    for row, length in hubs:
        lengths[row] = length
    indptr = torch.zeros(n_rows + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(lengths, 0)
    nnz = int(indptr[-1])
    indices = torch.randint(0, max(n_cols, 1), (nnz + pad,), generator=gen,
                            device=dev, dtype=torch.int32)
    data = torch.randn(nnz + pad, generator=gen, device=dev, dtype=dtype)
    data[nnz:] = float("nan")
    return indptr, indices, data


def check_csr_product(got, want, indptr, indices, data, b, what):
    """The sparse tolerance: |kernel - plain| <= rel (|A|·|B|)_row + rel,
    rel = SPARSE_REL in f32 and SPARSE_REL_F64 in f64, with NaN and inf in
    the same places. Returns the max abs error over finite outputs."""
    import torch

    from raft_tpu_torch.sparse import grid_spmv as tg

    n_rows = indptr.shape[0] - 1
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: shape or dtype")
    check(torch.equal(torch.isnan(got), torch.isnan(want))
          and torch.equal(torch.isinf(got), torch.isinf(want)),
          f"{what}: NaN/inf positions differ")
    bb = b.abs().reshape(b.shape[0], -1)
    mass = tg._spmm_plain(indptr, indices, data.abs(), bb, n_rows).reshape(
        got.shape)
    rel = SPARSE_REL if got.dtype == torch.float32 else SPARSE_REL_F64
    fin = torch.isfinite(want)
    err = (got - want).abs()[fin]
    check(bool((err <= rel * mass[fin] + rel).all()),
          f"{what}: max err {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def sparse_pair(indptr, indices, data, b, n_rows, what):
    """Kernel (``_spmm``: csr_spmv for k = 1, csr_spmm above) twice, bitwise
    equal, and against the plain version. Returns the max abs error."""
    import torch

    from raft_tpu_torch.sparse import grid_spmv as tg

    got = tg._spmm(indptr, indices, data, b, n_rows)
    again = tg._spmm(indptr, indices, data, b, n_rows)
    check(torch.equal(got.view(torch.uint8), again.view(torch.uint8)),
          f"{what}: two runs differ")
    want = tg._spmm_plain(indptr, indices, data, b, n_rows)
    return check_csr_product(got, want, indptr, indices, data, b, what)


def sparse_parity(dev):
    """csr_spmv and csr_spmm against their plain versions on the card: a
    hub row of 100,000 entries, empty rows, an empty matrix, a stored zero
    against x = inf, a padded CSR, a non-square matrix, f64, and
    k = 1, 2, 31, 32, 33, 64."""
    import torch

    from raft_tpu_torch.sparse import grid_spmv as tg

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    errs = {"csr_spmv": 0.0, "csr_spmm": 0.0}
    case_errs = {}
    cases = []
    for dtype in (torch.float32, torch.float64):
        # non-square, a hub row, a third of the rows empty, 5,000 pad
        # entries (NaN) past indptr[-1], x = inf at one column
        shape = (20000, 150000)
        indptr, indices, data = make_csr(gen, dev, *shape, max_len=40,
                                         hubs=[(7, 100000), (19999, 3000)],
                                         pad=5000, dtype=dtype)
        for k in SPARSE_KS:
            b = torch.randn(shape[1], k, generator=gen, device=dev,
                            dtype=dtype)
            b[int(indices[0]), 0] = float("inf")
            name = "csr_spmv" if k == 1 else "csr_spmm"
            what = f"{name} {dtype} k={k}"
            case_errs[what] = sparse_pair(indptr, indices, data, b, shape[0],
                                          what)
            errs[name] = max(errs[name], case_errs[what])
            empty = indptr[1:] == indptr[:-1]
            got = tg._spmm(indptr, indices, data, b, shape[0])
            check(bool((got[empty] == 0).all()), f"{what}: empty rows")
            cases.append(what)
    # a stored zero against x = inf: NaN in its row, no other row touched
    indptr = torch.tensor([0, 2, 3], dtype=torch.int32, device=dev)
    indices = torch.tensor([0, 1, 0], dtype=torch.int32, device=dev)
    data = torch.tensor([2.0, 0.0, 3.0], device=dev)
    x = torch.tensor([1.0, float("inf")], device=dev)
    y = tg._spmv(indptr, indices, data, x, 2)
    check(bool(torch.isnan(y[0])) and float(y[1]) == 3.0,
          f"stored zero against inf: got {y.tolist()}")
    yb = tg._spmm(indptr, indices, data, torch.stack([x, x], 1), 2)
    check(bool(torch.isnan(yb[0]).all()) and bool((yb[1] == 3.0).all()),
          "stored zero against inf (spmm)")
    # an empty matrix: every row exactly 0
    indptr = torch.zeros(1001, dtype=torch.int32, device=dev)
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    for k in (1, 33):
        out = tg._spmm(indptr, none, torch.zeros(0, device=dev),
                       torch.ones(500, k, device=dev), 1000)
        check(torch.equal(out, torch.zeros(1000, k, device=dev)),
              f"empty matrix k={k}")
    cases += ["stored zero vs inf", "empty matrix"]
    emit("sparse_parity", cases=cases, max_abs_err=errs,
         max_abs_err_by_case=case_errs, bitwise_repeatable=True,
         tolerance=f"|kernel - plain| <= rel x (|A|.|B|)_row + rel, rel "
                   f"{SPARSE_REL} (f32) or {SPARSE_REL_F64} (f64); NaN/inf "
                   f"positions equal; empty rows 0")
    return errs


# ---------------------------------------------------------------------------
# phase 8: BASELINE config 4 (R-MAT, SpMV, SpMM, Lanczos) on the card
# ---------------------------------------------------------------------------


def csr_from_edges(src, dst, n, weights=None):
    """Symmetric CSR adjacency on the edges' device: self-loops dropped,
    duplicate directed edges summed, then symmetrized with max, as
    benches/bench_prims.py:877-889 builds BASELINE config 4's graph
    (scipy's ``adj.maximum(adj.T)``)."""
    import numpy as np
    import torch

    from raft_tpu_torch.core.sparse_types import COOMatrix
    from raft_tpu_torch.sparse import convert, linalg, op

    keep = src != dst
    src, dst = src[keep].to(torch.int32), dst[keep].to(torch.int32)
    w = torch.ones(src.shape[0], dtype=torch.float32, device=src.device) \
        if weights is None else weights[keep]
    coo = op.sum_duplicates(COOMatrix(src, dst, w, (n, n)))
    sym = linalg.coo_symmetrize(coo, np.maximum.reduceat)
    return convert.sorted_coo_to_csr(sym)


def graph_stats(csr):
    lengths = (csr.indptr[1:] - csr.indptr[:-1]).long()
    return dict(n=csr.n_rows, nnz=csr.logical_nnz(),
                isolated=int((lengths == 0).sum()),
                longest_row=int(lengths.max()),
                rows_over_1024=int((lengths > 1024).sum()),
                mean_degree=csr.logical_nnz() / csr.n_rows)


def spmv_bound(nnz, n_rows, n_cols, k, idx_bytes):
    """Least bytes over the HBM rate (ms): each entry's index and value,
    indptr, B (or x) and C (or y) once."""
    b = nnz * 8 + (n_rows + 1) * idx_bytes + 4 * n_cols * k + 4 * n_rows * k
    return b / PEAK_BYTES * 1e3, b


def rows_subset(csr, keep_rows):
    """The CSR with only ``keep_rows`` (a bool mask) keeping entries."""
    import torch

    from raft_tpu_torch.core.sparse_types import CSRMatrix

    lengths = (csr.indptr[1:] - csr.indptr[:-1]).long()
    mask = keep_rows.repeat_interleave(lengths)
    indptr = torch.zeros_like(csr.indptr)
    indptr[1:] = torch.cumsum(torch.where(keep_rows, lengths, 0), 0)
    return CSRMatrix(indptr, csr.indices[mask], csr.data[mask], csr.shape)


def lanczos_sync_cost(csr, steps=20, reps=3):
    """Host ms per Lanczos step with the per-step breakdown sync (the
    port's loop) and without it, alternating, on the config-4 operator."""
    import torch

    from raft_tpu_torch.sparse import grid_spmv, linalg
    from raft_tpu_torch.sparse.solver import lanczos as tl

    plan = linalg._cached_plan(csr)
    n = csr.n_rows
    gen = torch.Generator(device=csr.device).manual_seed(SEED + 8)
    v0 = torch.randn(n, generator=gen, device=csr.device)
    v0 = v0 / torch.linalg.vector_norm(v0)

    def run(sync):
        basis = torch.zeros((steps, n), device=csr.device)
        scale = torch.zeros((), device=csr.device)
        v = v0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(steps):
            w, _, b, scale, bad = tl._lanczos_step(
                lambda u: linalg.grid_spmv.spmv(plan, u), basis, v, j, scale)
            if sync:
                bool(bad)
            v = w / b
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    run(True)
    out = {"sync": [], "no_sync": []}
    for _ in range(reps):
        for sync in (False, True, True, False):
            out["sync" if sync else "no_sync"].append(run(sync))
    return {k: sum(v) / len(v) for k, v in out.items()}


def config4_phase(res, dev):
    """BASELINE config 4 at full size on one card: the R-MAT graph (scale
    20, 10M edges, a/b/c 0.57/0.19/0.19) built on the card by the port's
    generator, one SpMV, one SpMM at k = 16 and the fixed 3-restart
    Lanczos of bench_prims.py:890-893, all through the public entry
    points with the launch counts set to 0 just before."""
    import warnings

    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.random import RngState, rmat_rectangular_gen
    from raft_tpu_torch.sparse import grid_spmv, linalg
    from raft_tpu_torch.sparse.solver import (LanczosConfig,
                                              lanczos_compute_eigenpairs)

    t0 = time.perf_counter()
    src, dst = rmat_rectangular_gen(res, RngState(SEED + 9), RMAT_SCALE,
                                    RMAT_SCALE, RMAT_EDGES)
    g = csr_from_edges(src, dst, 1 << RMAT_SCALE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del src, dst
    stats = graph_stats(g)
    n = g.n_rows
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    x = torch.randn(n, generator=gen, device=dev)
    b16 = torch.randn(n, SPMM_K, generator=gen, device=dev)
    cfg = LanczosConfig(n_components=4, ncv=20, max_iterations=3,
                        tolerance=0.0)
    n_steps = cfg.ncv + (cfg.max_iterations - 1) * (cfg.ncv
                                                    - cfg.n_components)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    y = linalg.spmv(g, x)
    c16 = linalg.spmm(g, b16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # tol 0: by design
        vals, vecs, rep = lanczos_compute_eigenpairs(res, g, cfg,
                                                     return_report=True)
    torch.cuda.synchronize()
    lanczos_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    for name in ("csr_spmv", "csr_spmm"):
        check(launches[name] > 0, f"config-4 phase never launched {name}")
    check(launches["csr_spmv"] == 1 + n_steps,
          f"csr_spmv launches {launches['csr_spmv']}, want {1 + n_steps}")

    # checks, after the counted run
    err_v = check_csr_product(y, linalg.grid_spmv._spmv_plain(
        g.indptr, g.indices, g.data, x, n), g.indptr, g.indices, g.data, x,
        "config-4 spmv")
    err_m = check_csr_product(c16, linalg.grid_spmv._spmm_plain(
        g.indptr, g.indices, g.data, b16, n), g.indptr, g.indices, g.data,
        b16, "config-4 spmm k=16")
    check(tuple(vecs.shape) == (n, 4) and bool(torch.isfinite(vals).all())
          and bool(torch.isfinite(vecs).all()), "Ritz pairs not finite")
    gram = vecs.double().T @ vecs.double()
    orth = float((gram - torch.eye(4, device=dev,
                                   dtype=torch.float64)).abs().max())
    check(orth <= 1e-4, f"Ritz vectors not orthonormal: {orth}")
    check(rep.n_iter == cfg.max_iterations, f"n_iter {rep.n_iter}")

    spmv_ms = cuda_ms(lambda: linalg.spmv(g, x), 20)
    spmm_ms = cuda_ms(lambda: linalg.spmm(g, b16), 10)
    lengths = g.indptr[1:] - g.indptr[:-1]
    # the hub row's share of csr_spmm: config 4 without its longest row
    no_hub = rows_subset(g, lengths < lengths.max())
    no_hub_ms = cuda_ms(lambda: linalg.spmm(no_hub, b16), 10)
    no_hub_spmv_ms = cuda_ms(lambda: linalg.spmv(no_hub, x), 20)
    del no_hub
    tail = {"without_longest_row_spmm_k16_ms": no_hub_ms,
            "longest_row_share_of_spmm": 1.0 - no_hub_ms / spmm_ms,
            "without_longest_row_spmv_ms": no_hub_spmv_ms,
            "longest_row_share_of_spmv": 1.0 - no_hub_spmv_ms / spmv_ms}
    # the gathers' share of the SpMV: every column index 0, so that every
    # x[indices[j]] hits the cache, beside cuSPARSE on the same matrix
    zero_cols = torch.zeros_like(g.indices)
    owners = grid_spmv._spmv_owners(g.indptr, g.indices.numel())
    tail["columns_zeroed_spmv_ms"] = cuda_ms(lambda: grid_spmv._spmv(
        g.indptr, zero_cols, g.data, x, n, owners), 20)
    with warnings.catch_warnings():       # torch's sparse-CSR beta notices
        warnings.simplefilter("ignore", UserWarning)
        lib0 = torch.sparse_csr_tensor(g.indptr, zero_cols, g.data,
                                       size=g.shape)
    tail["columns_zeroed_cusparse_ms"] = cuda_ms(lambda: torch.mv(lib0, x),
                                                 20)
    del zero_cols, lib0, owners
    for part, rows in (("short_rows", lengths <= 1024),
                       ("long_rows", lengths > 1024)):
        sub = rows_subset(g, rows)
        tail[f"{part}_spmv_ms"] = cuda_ms(lambda: linalg.spmv(sub, x), 20)
        tail[f"{part}_spmm_k16_ms"] = cuda_ms(lambda: linalg.spmm(sub, b16),
                                              10)
        del sub
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        lanczos_ms = cuda_ms(lambda: lanczos_compute_eigenpairs(res, g, cfg),
                             2)
    qr_ms = cuda_ms(lambda: torch.linalg.qr(vecs), 5)
    sync = lanczos_sync_cost(g)
    step_ms = lanczos_ms / n_steps
    out = dict(graph=stats, build_s=build_s, spmv_ms=spmv_ms,
               spmm_k16_ms=spmm_ms, lanczos_first_call_s=lanczos_s,
               lanczos_ms=lanczos_ms,
               lanczos_ms_per_restart=lanczos_ms / cfg.max_iterations,
               lanczos_ms_per_step=step_ms, lanczos_steps=n_steps,
               spmv_share_of_step=spmv_ms / step_ms, hub_tail=tail,
               qr_n_by_4_ms=qr_ms, step_ms_with_sync=sync["sync"],
               step_ms_without_sync=sync["no_sync"],
               ritz_values=vals.tolist(), ritz_orthonormality_err=orth,
               max_abs_err={"csr_spmv": err_v, "csr_spmm": err_m},
               launches={k: v for k, v in launches.items() if v})
    emit("config4", **out)
    return g, x, b16, out, launches


# ---------------------------------------------------------------------------
# phase 9: spectral partition of a planted-partition graph of config-4 size
# ---------------------------------------------------------------------------


def planted_graph(res):
    """2^20 nodes in 4 equal blocks, about 9.5M undirected edges, 98% of
    them inside a block, drawn with numpy from the seed; the CSR is built
    on the card. Returns the CSR and each node's block."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 11)
    n, blocks = 1 << RMAT_SCALE, PLANTED_BLOCKS
    size = n // blocks
    inside = rng.random(PLANTED_EDGES) < PLANTED_INSIDE
    bs = rng.integers(0, blocks, PLANTED_EDGES)
    bd = np.where(inside, bs,
                  (bs + rng.integers(1, blocks, PLANTED_EDGES)) % blocks)
    src = bs * size + rng.integers(0, size, PLANTED_EDGES)
    dst = bd * size + rng.integers(0, size, PLANTED_EDGES)
    dev = res.device
    g = csr_from_edges(torch.as_tensor(src, device=dev),
                       torch.as_tensor(dst, device=dev), n)
    return g, torch.arange(n, device=dev) // size


def best_agreement(labels, truth, k):
    """Fraction of nodes labelled as their block under the best
    permutation of label ids."""
    import itertools

    import torch

    table = torch.zeros(k, k, dtype=torch.int64, device=labels.device)
    table.index_put_((labels.long(), truth.long()),
                     torch.ones_like(truth, dtype=torch.int64),
                     accumulate=True)
    best = max(sum(int(table[i, p[i]]) for i in range(k))
               for p in itertools.permutations(range(k)))
    return best / labels.numel()


def partition_phase(res, dev):
    """``spectral.partition(res, g, n_clusters=4)`` with its defaults, then
    both analyzers, with the launch counts set to 0 just before. After the
    counted run, the kernels are held against their plain versions at
    this path's shapes: csr_spmm on A·one_hot(labels) [2^20, 4] (the
    analyzers' product), csr_spmv on the partition's normalized
    Laplacian (the Lanczos operator), and fused_argmin on its k-means
    input (the embedding's 2^20 unit rows of 4 against 4 of them) on the
    wgmma tile and on the FMA tile, each call and the library's also
    split by a trace into kernel, busy and span time."""
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.linalg import contractions as tc
    from raft_tpu_torch.sparse import linalg
    from raft_tpu_torch.spectral import (analyze_modularity,
                                         analyze_partition, partition)
    from raft_tpu_torch.spectral.partition import _embedding

    t0 = time.perf_counter()
    g, truth = planted_graph(res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    stats = graph_stats(g)
    row = g.row_ids().long()
    planted_cut = int((truth[row] != truth[g.indices.long()]).sum()) // 2
    del row

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    labels, vals, vecs, rep = partition(res, g, n_clusters=4,
                                        return_report=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cut, cost = analyze_partition(res, g, 4, labels)
    q = analyze_modularity(res, g, 4, labels)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    for name in ("csr_spmv", "csr_spmm", "fused_lloyd"):
        check(launches[name] > 0, f"partition phase never launched {name}")

    # checks, after the counted run
    check(rep.converged, f"partition's Lanczos did not converge: {rep}")
    agree = best_agreement(labels, truth, PLANTED_BLOCKS)
    check(agree >= 0.99, f"labels recover the blocks at {agree}")
    cut = float(cut)
    check(abs(cut - planted_cut) <= 0.01 * planted_cut,
          f"edge cut {cut} vs planted {planted_cut}")
    check(bool(torch.isfinite(vals).all()), "eigenvalues not finite")
    plan = linalg._cached_plan(g)
    h = (labels.long()[:, None] == torch.arange(4, device=dev)).to(
        plan.data.dtype)
    err_m = sparse_pair(plan.indptr, plan.indices, plan.data, h, g.n_rows,
                        "partition csr_spmm A.one_hot(labels)")
    lap = linalg._cached_plan(linalg.laplacian_normalized(g))
    err_v = sparse_pair(lap.indptr, lap.indices, lap.data,
                        vecs[:, :1].to(lap.data.dtype), g.n_rows,
                        "partition csr_spmv on the normalized Laplacian")
    errs = {"csr_spmv": err_v, "csr_spmm": err_m}
    emb = _embedding(vecs).contiguous()
    pick = torch.randperm(emb.shape[0], device=dev)[:PLANTED_BLOCKS]
    cents = emb[pick].contiguous()
    m, k, argmin_part = emb.shape[0], emb.shape[1], {}
    for tier in ("high", "highest"):
        xs, ys = tc._side(emb, tier), tc._side(cents, tier)
        row = argmin_part[tier] = argmin_shape(
            tier, "l2", xs, ys, m, PLANTED_BLOCKS, k, m,
            lambda: torch.cdist(emb, cents).argmin(1),
            "torch.cdist(x, c).argmin(1)", 10)
        # a call's ms is short enough for its wrapper's host work to show
        row.update(call_breakdown(lambda: tc._fused_argmin(
            tier, "l2", xs, ys, m, PLANTED_BLOCKS, k), 10, "argmin"))
        row.update({f"library_{key}": v for key, v in call_breakdown(
            lambda: torch.cdist(emb, cents).argmin(1), 10, "argmin").items()
            if key != "kernel_ms"})
    del emb, cents, xs, ys
    out = dict(graph=stats, build_s=build_s, wall_s=wall,
               n_iter=rep.n_iter, converged=rep.converged,
               residual=rep.residual, breakdowns=rep.breakdowns,
               eigenvalues=vals.tolist(), agreement=agree, edge_cut=cut,
               planted_cut=planted_cut, ratio_cut_cost=float(cost),
               modularity=float(q), laplacian_nnz=lap.nnz,
               max_abs_err=errs,
               launches={k: v for k, v in launches.items() if v},
               fused_argmin_at_its_shape=argmin_part)
    emit("spectral_partition", **out)
    return launches, errs, argmin_part


def sparse_numbers(g, x, b16, launches, errs):
    """The two sparse kernels' rows at the config-4 shape: kernel, plain
    version and cuSPARSE (``torch.sparse_csr_tensor`` @, timed only)."""
    import warnings

    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.sparse import grid_spmv as tg

    n, nnz = g.n_rows, g.logical_nnz()
    with warnings.catch_warnings():       # torch's sparse-CSR beta notices
        warnings.simplefilter("ignore", UserWarning)
        lib = torch.sparse_csr_tensor(g.indptr, g.indices, g.data,
                                      size=g.shape)
    idx_bytes = g.indptr.element_size()
    ops = (g.indptr, g.indices, g.data)
    rows = []
    for name, k, dense, kernel, plain_fn, library, call in (
            ("csr_spmv", 1, x, tg._spmv, tg._spmv_plain,
             lambda: torch.mv(lib, x),
             "torch.mv(torch.sparse_csr_tensor(...), x) (cuSPARSE)"),
            ("csr_spmm", SPMM_K, b16, tg._spmm, tg._spmm_plain,
             lambda: lib @ b16,
             "torch.sparse_csr_tensor(...) @ B (cuSPARSE)")):
        b, nbytes = spmv_bound(nnz, n, n, k, idx_bytes)

        # the SpMV with its plan's chunk owners, as the entry points run it
        extra = (tg._spmv_owners(g.indptr, g.indices.numel()),) \
            if name == "csr_spmv" else ()

        def run(kernel=kernel, dense=dense, extra=extra):
            return kernel(*ops, dense, n, *extra)

        def plain(plain_fn=plain_fn, dense=dense):
            return plain_fn(*ops, dense, n)

        want = plain()
        got = run()
        err = check_csr_product(got, want, g.indptr, g.indices, g.data,
                                dense, f"{name} at config 4")
        lib_err = float((library().reshape(got.shape) - got).abs().max())
        spec = kernels.REGISTRY[name]
        ms = cuda_ms(run, 20)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"raft_tpu_torch/{spec.source}",
            "replaces": spec.replaces, "launches": launches[name],
            "max_abs_err": max(err, errs[name]), "ms": ms,
            "plain_ms": cuda_ms(plain, 5), "bound_ms": b,
            "bound_by": "bytes", "library_ms": cuda_ms(library, 20),
            "library_call": call, "library_max_abs_diff": lib_err,
            "parity": "pass", "shape": [n, n], "nnz": nnz, "k": k,
            "bytes": nbytes, "achieved_gb_s": nbytes / ms / 1e6})
    return rows


# ---------------------------------------------------------------------------
# phase 10: the unexpanded tile, the MST E-stage and the 1-NN probe
# against their plain versions
# ---------------------------------------------------------------------------


def unexp_rel(k):
    """Two f32 summation orders of k non-negative terms: 1e-5 sqrt(k) of
    the value (every unexpanded metric is its own mass)."""
    return 1e-5 * k ** 0.5


def equal_with_nan(a, b):
    import torch

    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


def unexpanded_parity(dev):
    """unexpanded_tile against its plain version (unexpanded_ref) for
    every metric, f32, bf16 and f64, at ragged shapes (k from 1 to 300),
    on integer-valued inputs (l1, linf and hamming exact in any order:
    equal) and on normal ones, with zero, NaN and inf entries. Two runs
    are bitwise equal. Returns the max abs error and which metrics were
    bitwise equal to plain throughout."""
    import torch

    from raft_tpu_torch.linalg import contractions as tc

    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    err, bitwise, cases = 0.0, {m: True for m in UNEXP_METRICS}, 0
    for m, n, k in ((1, 1, 1), (517, 301, 45), (33, 1000, 300),
                    (200, 129, 7)):
        for integer in (True, False):
            x = torch.randn(m, k, generator=gen, device=dev)
            y = torch.randn(n, k, generator=gen, device=dev)
            if integer:
                x, y = torch.round(3 * x), torch.round(3 * y)
            if m > 2 and n > 1:
                x[1] = 0.0                      # canberra 0/0 against y[0]
                y[0] = 0.0
                x[2, 0] = float("nan")          # linf keeps the NaN
                y[-1, k // 2] = float("inf")
            for dtype in (torch.float32, torch.bfloat16, torch.float64):
                xx, yy = x.to(dtype), y.to(dtype)
                wt = torch.float64 if dtype == torch.float64 else \
                    torch.float32
                for metric in UNEXP_METRICS:
                    what = f"unexpanded {metric} {dtype} {m}x{n}x{k}" \
                           f"{' int' if integer else ''}"
                    got = tc.pairwise_unexpanded_pallas(xx, yy, metric, 3.0)
                    again = tc.pairwise_unexpanded_pallas(xx, yy, metric,
                                                          3.0)
                    check(got.dtype == wt and torch.equal(
                        got.view(torch.uint8), again.view(torch.uint8)),
                        f"{what}: dtype or two runs differ")
                    want = tc.unexpanded_ref(xx.to(wt), yy.to(wt), metric,
                                             3.0)
                    check(torch.equal(torch.isnan(got), torch.isnan(want)),
                          f"{what}: NaN positions")
                    same = equal_with_nan(got, want)
                    bitwise[metric] &= same
                    if integer and metric in UNEXP_EXACT:
                        check(same, f"{what}: not exact")
                    fin = torch.isfinite(want)
                    e = (got - want).abs()[fin].double()
                    check(bool((e <= unexp_rel(k) * want.abs()[fin] + 1e-6
                                ).all()), f"{what}: max err {float(e.max())}")
                    err = max(err, float(e.max()) if e.numel() else 0.0)
                    if m > 2 and n > 1:
                        if metric == "canberra":
                            check(float(got[1, 0]) == 0.0, f"{what}: 0/0")
                        if metric == "linf":
                            check(bool(torch.isnan(got[2]).all()),
                                  f"{what}: NaN dropped by the max")
                    cases += 1
    return err, bitwise, cases


def mst_edge_parity(dev):
    """mst_min_edge against its plain version: a 100,000-entry hub row,
    empty rows, a self-loop, 5,000 NaN pads past indptr[-1] (never read),
    random and all-equal weights, f32 and f64, four colorings. Exact."""
    import torch

    from raft_tpu_torch.sparse.solver import mst_grid as tmg

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    cases = 0
    for dtype in (torch.float32, torch.float64):
        n = 20000
        indptr, indices, data = make_csr(gen, dev, n, n, max_len=40,
                                         hubs=[(7, 100000), (n - 1, 3000)],
                                         pad=5000, dtype=dtype)
        r = int(torch.nonzero(indptr[1:] > indptr[:-1])[0, 0])
        indices[int(indptr[r])] = r                 # a self-loop
        for weights in (data.abs() + 0.01,
                        torch.where(torch.isnan(data), data, 1.0)):
            plan = tmg.MSTPlan(indptr=indptr, indices=indices, data=weights,
                               n=n, n_cols=n, n_edges=int(indptr[-1]))
            for colors in (torch.arange(n, device=dev),
                           torch.randint(0, 50, (n,), generator=gen,
                                         device=dev),
                           torch.randint(0, 2, (n,), generator=gen,
                                         device=dev),
                           torch.zeros(n, device=dev)):
                colors = colors.to(torch.int32)
                got = tmg._min_edge(plan, colors)
                again = tmg._min_edge(plan, colors)
                want = tmg._min_edge_plain(indptr, indices, weights, colors,
                                           n, n)
                for a, b, c in zip(got, again, want):
                    check(a.dtype == c.dtype and torch.equal(a, b)
                          and torch.equal(a, c),
                          f"mst_min_edge {dtype}: kernel differs from plain")
                cases += 1
    return cases


def probe_parity(dev):
    """minonly against its plain version at all three tiers over several
    database splits: bitwise on integer-valued inputs (every sum exact),
    indices equal but at near-ties and values within REL on normal ones
    (recording whether they were bitwise equal too)."""
    import torch

    from raft_tpu_torch.linalg import contractions as tc
    from raft_tpu_torch.neighbors import fused_topk as tft

    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    m, n, kd = 517, 30001, 45
    err, bitwise, mismatches = 0.0, {}, 0
    for tier in ("default", "high", "highest"):
        for integer in (True, False):
            x = torch.randn(m, kd, generator=gen, device=dev)
            y = torch.randn(n, kd, generator=gen, device=dev)
            if integer:
                x, y = torch.round(2 * x), torch.round(2 * y)
            y[29000] = y[17]                     # tie: column 17 first
            x[0] = y[17]
            xs, ys = tc._side(x, tier), tc._side(y, tier)
            got = tft._minonly(tier, xs, ys, m, n, kd)
            again = tft._minonly(tier, xs, ys, m, n, kd)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"minonly {tier}: two runs differ")
            want = tft._minonly_plain(tier, xs, ys, m, n, kd)
            check(int(got[1][0]) == 17, f"minonly {tier}: tie order")
            same = torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                 want[1])
            what = f"minonly {tier}{' int' if integer else ''}"
            if integer:
                check(same, f"{what}: not bitwise equal to plain")
            else:
                bitwise[tier] = same
                scale = ((x.double() ** 2).sum(1)
                         + (y.double() ** 2).sum(1).max()).float()
                mismatches += labels_agree(
                    got[1], want[1], plain_rows(tier, "l2", xs, ys, n, kd),
                    scale, REL, what).numel()
                ok = got[1] == want[1]
                e = (got[0] - want[0]).abs()[ok]
                check(bool((e <= REL * scale[ok] + 1e-6).all()),
                      f"{what}: values off by {float(e.max())}")
                err = max(err, float(e.max()))
    return err, bitwise, mismatches


def new_kernel_parity(dev):
    err_u, bit_u, cases_u = unexpanded_parity(dev)
    cases_m = mst_edge_parity(dev)
    err_p, bit_p, mis_p = probe_parity(dev)
    errs = {"unexpanded_tile": err_u, "mst_min_edge": 0.0, "minonly": err_p}
    emit("new_kernel_parity", unexpanded_cases=cases_u,
         unexpanded_bitwise_to_plain=bit_u, mst_min_edge_cases=cases_m,
         minonly_bitwise_to_plain_on_normal_data=bit_p,
         minonly_near_tie_mismatches=mis_p, max_abs_err=errs,
         tolerance=f"unexpanded: |kernel - plain| <= 1e-5 sqrt(k) x value "
                   f"+ 1e-6, exact for {list(UNEXP_EXACT)} on integer "
                   f"inputs, NaN positions equal; mst_min_edge exact; "
                   f"minonly bitwise on integer inputs, else indices equal "
                   f"but within {REL} x (|x|^2 + max|y|^2) and values "
                   f"within that band")
    return errs


# ---------------------------------------------------------------------------
# phase 11: unexpanded pairwise distances, BASELINE config 1's shape
# ---------------------------------------------------------------------------


# DistanceType -> (kernel metric, epilogue) as pairwise_distance applies it
UNEXP_DISTANCES = {
    "L2Unexpanded": ("l2un", lambda d, k: d),
    "L2SqrtUnexpanded": ("l2un", lambda d, k: d.sqrt()),
    "L1": ("l1", lambda d, k: d),
    "Linf": ("linf", lambda d, k: d),
    "Canberra": ("canberra", lambda d, k: d),
    "LpUnexpanded": ("lp", lambda d, k: d ** (1.0 / 3.0)),
    "HammingUnexpanded": ("hamming", lambda d, k: d / k),
}


def unexpanded_pairwise_phase(res, dev):
    """The seven unexpanded metrics through pairwise_distance at 5000 x 50
    (y = None): one unexpanded_tile launch each, the diagonal exactly 0,
    the rest against the plain version on the card (the same epilogue
    over unexpanded_ref). Returns the launches and the max error."""
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.distance import DistanceType, pairwise_distance
    from raft_tpu_torch.linalg import contractions as tc

    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    x = blobs(gen, dev, PAIRWISE_M, PAIRWISE_K, 10)
    x[:, :5] = torch.round(x[:, :5])            # some exact matches
    k = PAIRWISE_K
    out, total, err = {}, 0, 0.0
    for name, (km, epi) in UNEXP_DISTANCES.items():
        metric = DistanceType[name]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        got = pairwise_distance(res, x, metric=metric, p=3.0)
        torch.cuda.synchronize()
        launches = {n: c for n, c in kernels.launch_counts().items() if c}
        check(launches == {"unexpanded_tile": 1},
              f"pairwise_distance {name}: launches {launches}")
        total += 1
        check(bool((got.diagonal() == 0).all()), f"{name}: diagonal")
        want = epi(tc.unexpanded_ref(x, x, km, 3.0), k)
        want.fill_diagonal_(0.0)
        e = (got - want).abs()
        check(bool((e <= unexp_rel(k) * want.abs() + 1e-6).all()),
              f"pairwise_distance {name}: max err {float(e.max())}")
        err = max(err, float(e.max()))
        out[name] = {"ms": cuda_ms(lambda: pairwise_distance(
                         res, x, metric=metric, p=3.0), 5),
                     "max_abs_err": float(e.max()),
                     "bitwise_to_plain": torch.equal(got, want),
                     "launches": launches}
        del got, want, e
    lib = {"L1 torch.cdist(p=1)": lambda: torch.cdist(x, x, p=1.0),
           "Linf torch.cdist(p=inf)": lambda: torch.cdist(x, x,
                                                          p=float("inf")),
           "L2Sqrt torch.cdist(p=2, donot_use_mm)": lambda: torch.cdist(
               x, x, compute_mode="donot_use_mm_for_euclid_dist"),
           "Hamming torch.cdist(p=0) / k": lambda: torch.cdist(x, x,
                                                               p=0.0) / k}
    emit("unexpanded_pairwise", shape=[PAIRWISE_M, PAIRWISE_K], metrics=out,
         library_ms={n_: cuda_ms(f, 5) for n_, f in lib.items()},
         tolerance="|kernel - plain| <= 1e-5 sqrt(k) x value + 1e-6; "
                   "diagonal exactly 0")
    return total, err


# ---------------------------------------------------------------------------
# phase 12: unexpanded kNN at the kNN path's width
# ---------------------------------------------------------------------------


def exact_topk_check(idx, vals, exact, k, what):
    """The returned columns' exact distances, sorted, equal the exact top
    k within the tie band (1e-5 sqrt(d) of the k-th distance); the
    returned values within that band of their exact ones. Returns (max
    gap, rows whose index set is the exact one)."""
    import torch

    got = exact.gather(1, idx.long())
    best = torch.topk(exact, k, dim=1, largest=False)
    band = unexp_rel(KNN_D) * best.values[:, -1:] + 1e-6
    gap = (torch.sort(got, dim=1).values - best.values).abs()
    check(bool((gap <= band).all()),
          f"{what}: off the exact top k by {float(gap.max())}")
    e = (vals.double() - got).abs()
    check(bool((e <= band).all()), f"{what}: distances off by "
          f"{float(e.max())}")
    rows = int((torch.sort(idx.long(), 1).values
                == torch.sort(best.indices, 1).values).all(1).sum())
    return float(gap.max()), rows


def unexpanded_knn_phase(res, dev, db, q):
    """knn with l1 at 4096 queries, k = 64 (the radix route, 32 chunks of
    32,768 columns through unexpanded_tile, radix_threshold and
    radix_emit), then linf and canberra at 256 queries; indices against
    an exact f64 search on the card for 256 queries. Returns the launches
    and the l1 call's ms."""
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.linalg import contractions as tc
    from raft_tpu_torch.neighbors import knn, knn_plan

    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    sample = torch.randperm(KNN_Q, generator=gen, device=dev)[:UNEXP_Q]
    db64 = db.double()
    total = {}
    calls = {}
    for metric, nq in (("l1", KNN_Q), ("linf", UNEXP_Q),
                       ("canberra", UNEXP_Q)):
        qq = q if nq == KNN_Q else q[sample]
        path, chunk = knn_plan(nq, KNN_N, UNEXP_K, metric)
        check(path == "radix", f"knn {metric}: route {path}, want radix")
        n_chunks = -(-KNN_N // chunk)
        check(metric != "l1" or n_chunks == 32,
              f"knn l1: {n_chunks} chunks, want 32")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        vals, idx = knn(res, db, qq, UNEXP_K, metric=metric)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n_: c for n_, c in kernels.launch_counts().items() if c}
        want = {"unexpanded_tile": n_chunks, "radix_threshold": n_chunks,
                "radix_emit": n_chunks}
        check(counts == want, f"knn {metric}: launches {counts}, want "
              f"{want}")
        for n_, c in counts.items():
            total[n_] = total.get(n_, 0) + c
        check(tuple(idx.shape) == (nq, UNEXP_K) and idx.dtype == torch.int32
              and bool(torch.isfinite(vals).all())
              and bool((vals[:, 1:] >= vals[:, :-1]).all()),
              f"knn {metric}: output")
        ms = cuda_ms(lambda: knn(res, db, qq, UNEXP_K, metric=metric), 2)
        rows = sample if nq == KNN_Q else torch.arange(UNEXP_Q, device=dev)
        q64 = qq[rows].double()
        if metric == "l1":
            exact = torch.cdist(q64, db64, p=1.0)
        elif metric == "linf":
            exact = torch.cdist(q64, db64, p=float("inf"))
        else:
            exact = tc.unexpanded_ref(q64, db64, "canberra")
        gap, exact_rows = exact_topk_check(idx[rows], vals[rows], exact,
                                           UNEXP_K, f"knn {metric}")
        calls[metric] = dict(queries=nq, route=path, chunk=chunk, wall_s=wall,
                             ms=ms, launches=counts, max_gap_to_exact=gap,
                             sample_rows_with_exact_set=exact_rows)
        del vals, idx, exact
        torch.cuda.empty_cache()
    emit("unexpanded_knn", db=[KNN_N, KNN_D], k=UNEXP_K, checked=UNEXP_Q,
         calls=calls, launches=total,
         tolerance="exact f64 top-k distances (torch.cdist p=1 / p=inf, "
                   "f64 unexpanded_ref for canberra) within 1e-5 sqrt(d) "
                   "of the k-th of the returned columns'")
    return total, calls


def unexpanded_numbers(db, q, launches, parity_err):
    """unexpanded_tile's row at the l1 kNN route's chunk (4096 x 32,768 x
    128, the first chunk of the path's own data): every metric held
    against its plain version there (bitwise for all but lp, lp within
    1e-5 sqrt(k) of the value), timed beside its bound and, where one
    call computes it, torch.cdist; the l1 row beside the plain version's
    time. Then radix_threshold at that chunk's keys (k = 64), exactly
    against its plain version and timed. Returns the row and the
    threshold's numbers."""
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.linalg import contractions as tc
    from raft_tpu_torch.matrix import radix_select as trs
    from raft_tpu_torch.neighbors import knn_plan

    nq, d = q.shape
    cw = knn_plan(nq, KNN_N, UNEXP_K, "l1")[1]
    y = db[:cw].contiguous()
    with torch.no_grad():
        per_metric, err = {}, 0.0
        for metric, instr in UNEXP_INSTR.items():
            got = tc._unexpanded_tile(metric, 3.0, q, y)
            want = tc.unexpanded_ref(q, y, metric, 3.0)
            e = (got - want).abs()
            check(bool((e <= unexp_rel(d) * want + 1e-6).all()),
                  f"unexpanded_tile {metric} at the kNN chunk: max err "
                  f"{float(e.max())}")
            bitwise = torch.equal(got, want)
            check(bitwise or metric not in UNEXP_BITWISE,
                  f"unexpanded_tile {metric} at the kNN chunk: not bitwise "
                  f"equal to its plain version")
            err = max(err, float(e.max()))
            if metric == "l1":
                keys = trs._to_key(got, True).contiguous()
            del got, want, e
            per_metric[metric] = dict(
                ms=cuda_ms(lambda: tc._unexpanded_tile(metric, 3.0, q, y), 3),
                bound_ms=unexp_bound(nq, cw, d, instr)[0],
                bitwise_to_plain=bitwise)
        lib = {"l1": lambda: torch.cdist(q, y, p=1.0),
               "linf": lambda: torch.cdist(q, y, p=float("inf")),
               "l2un": lambda: torch.cdist(
                   q, y, compute_mode="donot_use_mm_for_euclid_dist"),
               "hamming": lambda: torch.cdist(q, y, p=0.0)}
        for metric, fn in lib.items():
            per_metric[metric]["library_ms"] = cuda_ms(fn, 3)
        b, by = unexp_bound(nq, cw, d, UNEXP_INSTR["l1"])
        spec = kernels.REGISTRY["unexpanded_tile"]
        row = {"name": "unexpanded_tile", "route": "cuda",
               "source": f"raft_tpu_torch/{spec.source}",
               "replaces": spec.replaces,
               "launches": launches["unexpanded_tile"],
               "max_abs_err": max(err, parity_err),
               "ms": per_metric["l1"]["ms"],
               "plain_ms": cuda_ms(lambda: tc.unexpanded_ref(q, y, "l1"), 2),
               "bound_ms": b, "bound_by": by,
               "library_ms": per_metric["l1"]["library_ms"],
               "library_call": "torch.cdist(x, y, p=1)", "parity": "pass",
               "shape": [nq, cw, d], "metric": "l1",
               "bitwise_to_plain_at_this_shape": per_metric["l1"][
                   "bitwise_to_plain"],
               "by_metric": per_metric}
        # the l1 route's radix_threshold, at the keys of this chunk
        exact_equal(trs._radix_threshold(keys, UNEXP_K),
                    trs._threshold_plain(keys, UNEXP_K),
                    "radix_threshold at the l1 kNN chunk")
        threshold = dict(
            shape=[nq, cw], k=UNEXP_K,
            ms=cuda_ms(lambda: trs._radix_threshold(keys, UNEXP_K), 5),
            plain_ms=cuda_ms(lambda: trs._threshold_plain(keys, UNEXP_K), 3),
            bound_ms=(4 * nq * cw + 8 * nq) / PEAK_BYTES * 1e3,
            bound_by="bytes",
            library_ms=cuda_ms(lambda: torch.kthvalue(keys, UNEXP_K, dim=1),
                               3))
        # and its radix_emit
        t, ntie = trs._radix_threshold(keys, UNEXP_K)
        want = (trs._emit_plain(keys, t, ntie, UNEXP_K),)
        exact_equal((trs._radix_emit(keys, t, ntie, UNEXP_K),), want,
                    "radix_emit at the l1 kNN chunk")
        exact_equal((emit_lookback(keys, t, ntie, UNEXP_K),), want,
                    "radix_emit's look-back form at the l1 kNN chunk")
        del want
        emit_l1 = dict(
            shape=[nq, cw], k=UNEXP_K,
            form=trs._emit_plan(nq, cw).form,
            ms=cuda_ms(lambda: trs._radix_emit(keys, t, ntie, UNEXP_K), 5),
            lookback_ms=cuda_ms(lambda: emit_lookback(keys, t, ntie,
                                                      UNEXP_K), 5),
            plain_ms=cuda_ms(lambda: trs._emit_plain(keys, t, ntie, UNEXP_K),
                             3),
            bound_ms=(4 * nq * cw + 4 * nq * UNEXP_K) / PEAK_BYTES * 1e3,
            bound_by="bytes",
            library_ms=cuda_ms(lambda: torch.topk(keys, UNEXP_K, dim=1,
                                                  largest=False), 3),
            library_call="torch.topk(keys, k, largest=False)")
    return row, threshold, emit_l1


def unexp_bound(m, n, k, instr):
    """Lane instructions over the f32 issue rate, or the operand and
    output bytes over the HBM rate, whichever is larger."""
    t_ops = instr * m * n * k / PEAK_LANE_INSTR * 1e3
    t_bytes = 4 * (m * k + n * k + m * n) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "bytes" if t_bytes > t_ops else "operations"


# ---------------------------------------------------------------------------
# phase 13: Borůvka MST on bench_mst's R-MAT graph at full size
# ---------------------------------------------------------------------------


def mst_phase(res, dev):
    """mst(res, g) on benches/bench_prims.py:967-981's graph (R-MAT scale
    20, 10M edges, self-loops dropped, weights uniform in [0.01, 1.01)
    f32, duplicates summed, symmetrized with max), built on the card;
    warm, then counted and timed. Checks: n - n_components forest edges,
    the f64 total weight equal to scipy's exactly, and the kernel route's
    forest and colors bitwise equal to the plain E-stage's on the card."""
    import importlib

    import numpy as np
    import torch
    from scipy.sparse import csgraph

    from raft_tpu_torch import kernels
    from raft_tpu_torch.random import RngState, rmat_rectangular_gen
    from raft_tpu_torch.sparse import grid_spmv as tgs
    from raft_tpu_torch.sparse.solver import mst
    from raft_tpu_torch.sparse.solver import mst_grid as tmg

    tmst = importlib.import_module("raft_tpu_torch.sparse.solver.mst")
    t0 = time.perf_counter()
    n = 1 << RMAT_SCALE
    src, dst = rmat_rectangular_gen(res, RngState(SEED + 17), RMAT_SCALE,
                                    RMAT_SCALE, RMAT_EDGES)
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    w = torch.rand(src.shape[0], generator=gen, device=dev) + 0.01
    g = csr_from_edges(src, dst, n, w)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del src, dst, w
    stats = graph_stats(g)

    mst(res, g)                                     # warm
    colors = np.arange(n, dtype=np.int32)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    forest = mst(res, g, color=colors)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    rounds = launches["mst_min_edge"]
    check(rounds > 0, "mst never launched mst_min_edge")
    # a call's wall time: the rounds poll the host, so the device time
    # between two events around whole calls is the wall time
    call_ms = cuda_ms(lambda: mst(res, g), 3)

    # where a round's time goes: the kernel, then the V-sized torch work,
    # then the host poll, with CUDA events around each part
    plan = tmg.prepare_mst(g)
    c = torch.arange(n, dtype=torch.int32, device=dev)
    lengths = (plan.indptr[1:] - plan.indptr[:-1]).long()
    emit("mst_plan", n_rows=n, entries=plan.indices.numel(),
         chunk=tgs.SPMV_SEG, lanes=plan.lanes,
         chunks=plan.owners.numel(),
         tail_chunks=int((plan.owners >= 0).sum()),
         long_rows=int((lengths > tgs.SPMV_SEG).sum()),
         longest_row=int(lengths.max()),
         longest_row_chunks=-(-int(lengths.max()) // tgs.SPMV_SEG))
    per_round, round_ms = [], []
    for _ in range(rounds):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        vmin = tmg._min_edge(plan, c)
        ev[1].record()
        c_next, _, _, n_incl = tmst._color_stage(c, plan, n, *vmin)
        ev[2].record()
        int(n_incl)
        per_round.append((ev[0].elapsed_time(ev[1]),
                          ev[1].elapsed_time(ev[2])))
        # the kernel at this round's coloring: exactly the plain version,
        # and timed alone
        want = tmg._min_edge_plain(plan.indptr, plan.indices, plan.data, c,
                                   plan.n_cols, n)
        check(all(torch.equal(a, b) for a, b in zip(vmin, want)),
              f"mst_min_edge at round {len(round_ms)}: kernel differs from "
              f"plain")
        round_ms.append(cuda_ms(lambda: tmg._min_edge(plan, c), 10))
        c = c_next
        del want
    k_ms = sum(a for a, _ in per_round)
    v_ms = sum(b for _, b in per_round)

    # checks, after the counted run
    half = forest.n_edges // 2
    total = float(forest.weights[:half].double().sum())
    host = g.to_scipy().astype(np.float64)
    t0 = time.perf_counter()
    ref = csgraph.minimum_spanning_tree(host)
    n_comp = int(csgraph.connected_components(host, directed=False)[0])
    scipy_s = time.perf_counter() - t0
    ref_total = float(ref.sum())
    check(half == n - n_comp, f"forest has {half} edges, want {n - n_comp}")
    check(total == ref_total, f"forest weight {total!r} != scipy's "
          f"{ref_total!r}")
    plain = lambda p_, c_: tmg._min_edge_plain(  # noqa: E731
        p_.indptr, p_.indices, p_.data, c_, p_.n_cols, p_.n)
    pc, pmask, prounds = tmst._solve(
        plan, torch.arange(n, dtype=torch.int32, device=dev), plain)
    pforest = tmst._forest_output(plan, pmask, True)
    check(prounds == rounds and np.array_equal(pc.cpu().numpy(), colors)
          and all(torch.equal(getattr(forest, f), getattr(pforest, f))
                  for f in ("src", "dst", "weights")),
          "mst: kernel route and plain route differ")
    plain_round_ms = cuda_ms(lambda: plain(plan, torch.arange(
        n, dtype=torch.int32, device=dev)), 3)
    out = dict(graph=stats, build_s=build_s, rounds=rounds, host_polls=rounds,
               wall_s=wall, ms=call_ms,
               kernel_ms_total=k_ms, v_stage_ms_total=v_ms,
               per_round_kernel_v_ms=per_round,
               per_round_kernel_alone_ms=round_ms, forest_edges=half,
               components=n_comp, total_weight=total,
               scipy_total_weight=ref_total, scipy_s=scipy_s,
               plain_e_stage_round_ms=plain_round_ms,
               launches={k: v for k, v in launches.items() if v})
    emit("mst", **out)
    return g, plan, launches, out


def mst_numbers(plan, launches, round_ms):
    """mst_min_edge's row at the MST graph's first round (every vertex its
    own color): kernel, plain version and bound, beside the kernel's time
    at every round (``round_ms``, from mst_phase); no library call
    computes it."""
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.sparse.solver import mst_grid as tmg

    n, nnz = plan.n, plan.n_edges
    c = torch.arange(n, dtype=torch.int32, device=plan.device)
    got = tmg._min_edge(plan, c)
    want = tmg._min_edge_plain(plan.indptr, plan.indices, plan.data, c,
                               plan.n_cols, n)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "mst_min_edge at the MST graph: kernel differs from plain")
    # HBM bytes: indices and weights once each, indptr and colors once;
    # the triples written once. An entry's color comes from L2 (colors is
    # 4 n bytes), so it adds none.
    idx_bytes, w_bytes = plan.indptr.element_size(), plan.data.element_size()
    nbytes = (nnz * (4 + w_bytes) + (n + 1) * idx_bytes + 4 * n
              + n * (w_bytes + 8 + 4))
    ms = cuda_ms(lambda: tmg._min_edge(plan, c), 20)
    spec = kernels.REGISTRY["mst_min_edge"]
    return {"name": "mst_min_edge", "route": "cuda",
            "source": f"raft_tpu_torch/{spec.source}",
            "replaces": spec.replaces, "launches": launches["mst_min_edge"],
            "max_abs_err": 0.0, "ms": ms,
            "plain_ms": cuda_ms(lambda: tmg._min_edge_plain(
                plan.indptr, plan.indices, plan.data, c, plan.n_cols, n), 3),
            "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
            "library_ms": None, "library_call": "none", "parity": "pass",
            "shape": [n, n], "nnz": nnz, "bytes": nbytes,
            "achieved_gb_s": nbytes / ms / 1e6, "per_round_ms": round_ms}


# ---------------------------------------------------------------------------
# phase 14: the 1-NN floor probe at the kNN shape
# ---------------------------------------------------------------------------


def cdist_min(q, db, rows=131072):
    """The probe's library yardstick: cdist over database chunks, the
    chunk minima folded in order (the earlier chunk wins ties)."""
    import torch

    best_v = best_i = None
    for off in range(0, db.shape[0], rows):
        v, i = torch.cdist(q, db[off:off + rows]).min(1)
        if best_v is None:
            best_v, best_i = v, i + off
        else:
            better = v < best_v
            best_v = torch.where(better, v, best_v)
            best_i = torch.where(better, i + off, best_i)
    return best_v, best_i


def probe_phase(res, dev, db, q, parity_err, hgmma):
    """_minonly_probe at the kNN shape, 'high', counted; timed beside
    fused_topk at k = 1, 64 and 256 on the same operands, so the gap is
    the selection's share; indices against fused_argmin's on the same
    operands and against the plain version at 256 queries. Returns the
    probe's row and fused_argmin's numbers at this shape (its split
    walk)."""
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.linalg import contractions as tc
    from raft_tpu_torch.neighbors import fused_topk as tft
    from raft_tpu_torch.util import precision as tprec

    nq, d = q.shape
    n = db.shape[0]
    with tprec.scope("high"):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        vals, idx = tft._minonly_probe(q, db)
        torch.cuda.synchronize()
        launches = {n_: c for n_, c in kernels.launch_counts().items() if c}
        check(launches == {"minonly": 1}, f"probe launches {launches}")
        call_ms = cuda_ms(lambda: tft._minonly_probe(q, db), 2)
    with torch.no_grad():
        xs, ys = tc._side(q, "high"), tc._side(db, "high")
        ms = cuda_ms(lambda: tft._minonly("high", xs, ys, nq, n, d), 3)
        topk_ms = {kk: cuda_ms(lambda: tft._fused_topk(
            "high", "l2", xs, ys, nq, n, d, kk), 2) for kk in (1, 64, 256)}
        scale = ((q.double() ** 2).sum(1)
                 + (db.double() ** 2).sum(1).max()).float()
        av, ai = tc._fused_argmin("high", "l2", xs, ys, nq, n, d)
        pq = side_rows(xs, slice(0, PLAIN_Q))
        bad_argmin = labels_agree(
            idx, ai, lambda r: tc._pairwise_plain(
                "high", "l2", side_rows(xs, r), ys, r.numel(), n, d),
            scale, REL, "probe vs fused_argmin").numel()
        pv, pi = tft._minonly_plain("high", pq, ys, PLAIN_Q, n, d)
        bad_plain = labels_agree(idx[:PLAIN_Q], pi,
                                 plain_rows("high", "l2", pq, ys, n, d),
                                 scale[:PLAIN_Q], REL,
                                 "probe vs plain").numel()
        ok = idx[:PLAIN_Q] == pi
        e = (vals[:PLAIN_Q] - pv).abs()[ok]
        check(bool((e <= REL * scale[:PLAIN_Q][ok] + 1e-6).all()),
              f"probe values off the plain version by {float(e.max())}")
        err = max(float(e.max()), parity_err)
        plain_ms = cuda_ms(lambda: tft._minonly_plain("high", pq, ys,
                                                      PLAIN_Q, n, d), 2)
        lib_ms = cuda_ms(lambda: cdist_min(q, db), 1)
        del av, ai, pv, pi
        argmin_knn = argmin_shape(
            "high", "l2", xs, ys, nq, n, d, PLAIN_Q,
            lambda: cdist_min(q, db), "torch.cdist(q, db_chunk).min(1) over "
            "131,072-row chunks, folded in order", 3)
    b, by = bound("high", nq, n, d, 8 * nq)
    share = {kk: 1.0 - ms / t for kk, t in topk_ms.items()}
    emit("probe", shape=[nq, n, d], tier="high", call_ms=call_ms, ms=ms,
         fused_topk_ms=topk_ms, selection_share_of_fused_topk=share,
         differing_from_fused_argmin=bad_argmin,
         differing_from_plain_at_plain_q=bad_plain, launches=launches)
    spec = kernels.REGISTRY["minonly"]
    return argmin_knn, {"name": "minonly", "route": "cuda",
            "source": f"raft_tpu_torch/{spec.source}",
            "replaces": spec.replaces, "launches": launches.get("minonly", 0),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": lib_ms,
            "library_call": "torch.cdist(q, db_chunk).min(1) over 131,072-"
                            "row chunks, folded in order",
            "parity": "pass", "shape": [nq, n, d], "tier": "high",
            "tile": tft.ROUTE["high"], "hgmma": hgmma,
            "plain_q": PLAIN_Q, "fused_topk_ms": topk_ms,
            "selection_share_of_fused_topk": share}


def hgmma_count(build, kernels, name):
    """HGMMA (wgmma) instructions in kernel ``name``'s built library, by
    the toolkit's cuobjdump; None where the toolkit has none."""
    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    if not cuobjdump.is_file():
        return None
    lib = build.library_path(kernels.REGISTRY[name])
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    count = sass.count("HGMMA")
    check(count > 0, f"{name} built without wgmma instructions")
    return count


SASS_OPS = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "DADD",
            "DMUL", "DFMA", "MUFU", "LDS.128", "LDS", "STL", "LDL",
            "CALL")
# an instruction's opcode in cuobjdump's listing, after any predicate
SASS_OP = r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"


def unexpanded_sass(build, kernels):
    """The instruction mix of each f32 unexpanded_tile kernel (per metric,
    16-byte and element staging), counted in the built library's SASS by
    the toolkit's cuobjdump: l1, linf, hamming and l2un must hold no FFMA
    (their terms and running sums are rounded apart, as the plain version
    rounds them), and no kernel, f32 or f64, a local-memory access (a
    register spill). Fails where the toolkit has no cuobjdump beside its
    nvcc: the gate must run."""
    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    check(cuobjdump.is_file(), f"unexpanded_tile SASS: no {cuobjdump}, so "
          f"the FFMA and register-spill checks cannot run")
    lib = build.library_path(kernels.REGISTRY["unexpanded_tile"])
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    mix = {}
    for part in sass.split("Function : ")[1:]:
        m = re.search(r"unexpanded_tile_kernelI([fd])Li(\d)ELb([01])E", part)
        if not m:
            continue
        metric = UNEXP_METRICS[int(m.group(2))]
        ops = re.findall(SASS_OP, part)
        check(not any(o.startswith(("STL", "LDL")) for o in ops),
              f"unexpanded_tile {metric} {m.group(1)}: register spills")
        if m.group(1) != "f":
            continue
        count = {o: sum(1 for x in ops if x == o or (
            x.startswith(o + ".") and o != "LDS")) for o in SASS_OPS}
        count["all"] = len(ops)
        mix[f"{metric} {'vec' if m.group(3) == '1' else 'scalar'}"] = count
        if metric in ("l1", "linf", "hamming", "l2un"):
            check(count["FFMA"] == 0, f"unexpanded_tile {metric}: FFMA in "
                  f"the SASS contracts a term into the running sum")
    check(len(mix) == 2 * len(UNEXP_METRICS),
          f"unexpanded_tile SASS: found kernels {sorted(mix)}")
    return mix


def fingerprint(root):
    """``python3 chip_smoke.py --fingerprint ROOT``: pairwise_tile,
    fused_lloyd, fused_topk, minonly, topk_insert, unexpanded_tile,
    radix_threshold, radix_emit, csr_spmv and mst_min_edge on seeded
    inputs from the
    raft_tpu_torch package under ROOT (this checkout, or another commit's
    package unpacked beside it), each output hashed (SHA-256 of its
    bytes) and timed at the main paths' shapes (topk_insert at the
    WARPSORT_FILTERED shape on random, descending and ascending rows, k =
    64 and 256; unexpanded_tile, the radix kernels, csr_spmv and
    mst_min_edge as fingerprint_unexpanded, fingerprint_radix,
    fingerprint_spmv and fingerprint_mst say),
    and the kNN, select_k and mst calls that run them. Two packages whose hashes
    all agree give these kernels' outputs bit for bit; run them in turns
    (A, B, B, A) in one call to compare their times."""
    import hashlib

    sys.path.insert(0, os.path.abspath(root))
    import torch

    from raft_tpu_torch.kernels import build
    from raft_tpu_torch.linalg import contractions as tc
    from raft_tpu_torch.matrix import topk_insert as tti
    from raft_tpu_torch.neighbors import fused_topk as tft

    check(build.PACKAGE_DIR.parent.resolve() == Path(root).resolve(),
          f"raft_tpu_torch imported from {build.PACKAGE_DIR}, not {root}")
    build.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)

    def digest(outs):
        h = hashlib.sha256()
        for t in outs:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    hashes, times = {}, {}
    for m, n, k in ((3001, 1100, 45), (333, 177, 50), (20000, 8192, 128)):
        x = torch.randn(m, k, generator=gen, device=dev)
        y = torch.randn(n, k, generator=gen, device=dev)
        for tier in ("default", "high", "highest"):
            xs, ys = tc._side(x, tier), tc._side(y, tier)
            at = f"{tier} {m}x{n}x{k}"
            for metric in ("l2", "cosine", "inner"):
                hashes[f"pairwise_tile {metric} {at}"] = digest(
                    [tc._pairwise_tile(tier, metric, xs, ys, m, n, k)])
            hashes[f"fused_lloyd {at}"] = digest(tc._fused_lloyd(
                tier, xs, ys, m, n, k))
            for kk in (1, 64, 256):
                hashes[f"fused_topk k={kk} {at}"] = digest(tft._fused_topk(
                    tier, "l2", xs, ys, m, n, k, kk))
            hashes[f"minonly {at}"] = digest(tft._minonly(tier, xs, ys, m,
                                                          n, k))
    x = torch.randn(MAIN_M, MAIN_K, generator=gen, device=dev)
    c = x[:MAIN_N].clone()
    xs, cs = tc._side(x, "high"), tc._side(c, "high")
    hashes["fused_lloyd high main"] = digest(tc._fused_lloyd(
        "high", xs, cs, MAIN_M, MAIN_N, MAIN_K))
    times["fused_lloyd high main"] = cuda_ms(lambda: tc._fused_lloyd(
        "high", xs, cs, MAIN_M, MAIN_N, MAIN_K), 10)
    times["pairwise_tile high main"] = cuda_ms(lambda: tc._pairwise_tile(
        "high", "l2", xs, cs, MAIN_M, MAIN_N, MAIN_K), 10)
    del x, c, xs, cs
    torch.cuda.empty_cache()
    db = torch.randn(KNN_N, KNN_D, generator=gen, device=dev)
    q = torch.randn(KNN_Q, KNN_D, generator=gen, device=dev)
    qs, ds = tc._side(q, "high"), tc._side(db, "high")
    for kk in (64, 256):
        hashes[f"fused_topk k={kk} high knn"] = digest(tft._fused_topk(
            "high", "l2", qs, ds, KNN_Q, KNN_N, KNN_D, kk))
        times[f"fused_topk k={kk} high knn"] = cuda_ms(
            lambda: tft._fused_topk("high", "l2", qs, ds, KNN_Q, KNN_N,
                                    KNN_D, kk), 5)
    hashes["minonly high knn"] = digest(tft._minonly("high", qs, ds, KNN_Q,
                                                     KNN_N, KNN_D))
    times["minonly high knn"] = cuda_ms(lambda: tft._minonly(
        "high", qs, ds, KNN_Q, KNN_N, KNN_D), 5)
    del db, q, qs, ds
    torch.cuda.empty_cache()
    v = torch.randn(*SELECT_INSERT[:2], generator=gen, device=dev)
    desc = torch.sort(v, dim=1, descending=True).values
    for what, rows in (("random", v), ("descending", desc),
                       ("ascending", torch.flip(desc, dims=(1,)))):
        for kk in (SELECT_INSERT[2], 256):
            at = f"topk_insert k={kk} {what}"
            hashes[at] = digest(tti._topk_insert(rows, kk, True))
            times[at] = cuda_ms(lambda: tti._topk_insert(rows, kk, True), 20)
    del v, desc
    torch.cuda.empty_cache()
    fingerprint_unexpanded(gen, dev, digest, hashes, times)
    fingerprint_radix(gen, dev, digest, hashes, times)
    fingerprint_spmv(gen, dev, digest, hashes, times)
    fingerprint_mst(gen, dev, digest, hashes, times)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"fingerprint": str(root), "device": smi,
                      "hashes": hashes, "ms": times}))
    return 0


# the card test's ragged shapes of the unexpanded tile (m, n, k)
UNEXP_RAGGED = ((130, 257, 129), (1, 5, 1), (129, 1, 3), (300, 70, 50),
                (64, 128, 32), (257, 131, 128))


def unexpanded_operands(gen, dev, dtype, m, n, k, layout):
    """x [m, k], y [n, k]: contiguous, or views staged element by element
    (x a row stride of k + 1, y a slice from an odd row and column 1);
    exact matches, an inf and a NaN in x's last depth."""
    import torch

    if layout == "contiguous":
        x = torch.randn(m, k, generator=gen, device=dev, dtype=dtype)
        y = torch.randn(n, k, generator=gen, device=dev, dtype=dtype)
    else:
        x = torch.randn(m, k + 1, generator=gen, device=dev,
                        dtype=dtype)[:, :k]
        y = torch.randn(n + 3, k + 2, generator=gen, device=dev,
                        dtype=dtype)[3:, 1:k + 1]
    y[: n // 2, : k // 2] = x[0, : k // 2]
    if n > 2:
        y[-1, k // 3] = float("inf")
    x[-1, -1] = float("nan")
    return x, y


def fingerprint_unexpanded(gen, dev, digest, hashes, times):
    """unexpanded_tile in --fingerprint: every metric in f32 and f64 at the
    card test's ragged shapes (both stagings) and at config 1's 5000 x 50,
    hashed with NaN payloads made one (NaN positions kept); each metric
    timed at config 1 and at the l1 kNN route's 4096 x 32,768 x 128 chunk,
    l1's output there hashed."""
    import torch

    from raft_tpu_torch.linalg import contractions as tc

    def canon(t):
        return torch.where(torch.isnan(t), torch.full_like(t, float("nan")),
                           t)

    for dtype in (torch.float32, torch.float64):
        for m, n, k in UNEXP_RAGGED:
            for layout in ("contiguous", "strided"):
                x, y = unexpanded_operands(gen, dev, dtype, m, n, k, layout)
                for metric in UNEXP_METRICS:
                    hashes[f"unexpanded_tile {metric} {dtype} {m}x{n}x{k} "
                           f"{layout}"] = digest([canon(tc._unexpanded_tile(
                               metric, 3.0, x, y))])
        x5 = torch.randn(PAIRWISE_M, PAIRWISE_K, generator=gen, device=dev,
                         dtype=dtype)
        for metric in UNEXP_METRICS:
            at = f"unexpanded_tile {metric} {dtype} config1"
            hashes[at] = digest([canon(tc._unexpanded_tile(metric, 3.0, x5,
                                                           x5))])
            if dtype == torch.float32:
                times[at] = cuda_ms(lambda: tc._unexpanded_tile(
                    metric, 3.0, x5, x5), 10)
    q = torch.randn(KNN_Q, KNN_D, generator=gen, device=dev)
    y = torch.randn(32768, KNN_D, generator=gen, device=dev)
    hashes["unexpanded_tile l1 knn chunk"] = digest(
        [tc._unexpanded_tile("l1", 3.0, q, y)])
    for metric in UNEXP_METRICS:
        times[f"unexpanded_tile {metric} knn chunk"] = cuda_ms(
            lambda: tc._unexpanded_tile(metric, 3.0, q, y),
            1 if metric == "lp" else 3)
    torch.cuda.empty_cache()


def fingerprint_radix(gen, dev, digest, hashes, times):
    """radix_threshold and radix_emit in --fingerprint: (T, n_tie) and the
    winner columns hashed, and both timed, at the kNN radix route's chunk
    (4096 x 32,768 keys of l2 distances at k = 1024, of l1 distances at
    k = 64), the select shape (64 x 2^20, k = 2048; random, sorted and
    reverse-sorted rows), rows of ties and all-equal rows on both sides of
    the row-resident limit, a view with an odd row stride; then the
    paths that run them, timed and hashed: knn l1 at k = 64 and l2 at
    k = 1024 (4096 queries), linf and canberra at 256 queries, select_k
    AUTO at the select shape."""
    import torch

    from raft_tpu_torch import device_resources
    from raft_tpu_torch.linalg import contractions as tc
    from raft_tpu_torch.matrix import SelectAlgo, select_k
    from raft_tpu_torch.matrix import radix_select as trs
    from raft_tpu_torch.neighbors import knn
    from raft_tpu_torch.util import precision as tprec

    db = torch.randn(KNN_N, KNN_D, generator=gen, device=dev)
    q = torch.randn(KNN_Q, KNN_D, generator=gen, device=dev)
    chunk = db[:32768]
    ties = torch.randn(8, 300001, generator=gen, device=dev)
    ties[0, 50:150000] = -0.5
    ties[1] = 2.0
    short = torch.randn(512, 20000, generator=gen, device=dev)
    short[::3, 100:9000] = 0.25
    short[1::3] = -1.0
    sel = torch.randn(*SELECT_RADIX[:2], generator=gen, device=dev)
    cases = (("knn chunk l2", trs._to_key(torch.cdist(q, chunk) ** 2, True),
              KNN_KS[-1]),
             ("knn chunk l1", trs._to_key(tc.unexpanded_ref(q, chunk, "l1"),
                                          True), UNEXP_K),
             ("select", trs._to_key(sel, True), SELECT_RADIX[2]),
             ("ties stream", trs._to_key(ties, True), 120000),
             ("ties row", trs._to_key(short, True), 4096),
             ("select sorted", trs._to_key(torch.sort(sel, 1).values, True),
              SELECT_RADIX[2]),
             ("select reversed", trs._to_key(torch.sort(
                 sel, 1, descending=True).values, True), SELECT_RADIX[2]),
             ("odd stride", trs._to_key(ties, True)[:, 1:-2], 5000))
    for what, keys, k in cases:
        t, ntie = trs._radix_threshold(keys, k)
        hashes[f"radix_threshold {what}"] = digest([t, ntie])
        hashes[f"radix_emit {what}"] = digest([trs._radix_emit(keys, t, ntie,
                                                               k)])
        times[f"radix_threshold {what}"] = cuda_ms(
            lambda: trs._radix_threshold(keys, k), 10)
        times[f"radix_emit {what}"] = cuda_ms(
            lambda: trs._radix_emit(keys, t, ntie, k), 10)
    del cases, keys, t, ntie, sel
    torch.cuda.empty_cache()
    res = device_resources(dev, seed=SEED)
    with tprec.scope("high"):
        for what, qq, k, metric in (
                ("l1 k=64", q, UNEXP_K, "l1"),
                ("l2 k=1024", q, KNN_KS[-1], "l2"),
                ("linf k=64 256 queries", q[:UNEXP_Q], UNEXP_K, "linf"),
                ("canberra k=64 256 queries", q[:UNEXP_Q], UNEXP_K,
                 "canberra")):
            hashes[f"knn {what}"] = digest(list(knn(res, db, qq, k,
                                                    metric=metric)))
            times[f"knn {what}"] = cuda_ms(lambda: knn(res, db, qq, k,
                                                       metric=metric), 2)
    del db, q
    v = torch.randn(*SELECT_RADIX[:2], generator=gen, device=dev)
    hashes["select_k auto"] = digest(list(select_k(res, v, SELECT_RADIX[2],
                                                   algo=SelectAlgo.AUTO)))
    times["select_k auto"] = cuda_ms(lambda: select_k(
        res, v, SELECT_RADIX[2], algo=SelectAlgo.AUTO), 5)
    del v
    torch.cuda.empty_cache()


def fingerprint_spmv(gen, dev, digest, hashes, times):
    """csr_spmv in --fingerprint: y hashed on the parity phase's hub graph
    (a 100,000-entry hub row, NaN pads, f32 and f64, int32 and int64
    indptr), then hashed and timed on BASELINE config 4's graph (built as
    config4_phase builds it)."""
    import torch

    from raft_tpu_torch import device_resources
    from raft_tpu_torch.random import RngState, rmat_rectangular_gen
    from raft_tpu_torch.sparse import grid_spmv as tg

    n = 20000
    for dtype in (torch.float32, torch.float64):
        indptr, indices, data = make_csr(gen, dev, n, n, max_len=40,
                                         hubs=[(7, 100000)], pad=5000,
                                         dtype=dtype)
        x = torch.randn(n, generator=gen, device=dev, dtype=dtype)
        for idx in (torch.int32, torch.int64):
            hashes[f"csr_spmv hub {dtype} {idx}"] = digest([tg._spmv(
                indptr.to(idx), indices, data, x, n)])
    res = device_resources(dev, seed=SEED)
    src, dst = rmat_rectangular_gen(res, RngState(SEED + 9), RMAT_SCALE,
                                    RMAT_SCALE, RMAT_EDGES)
    g = csr_from_edges(src, dst, 1 << RMAT_SCALE)
    del src, dst
    x = torch.randn(g.n_rows, generator=gen, device=dev)
    ops = (g.indptr, g.indices, g.data, x, g.n_rows,
           tg._spmv_owners(g.indptr, g.indices.numel()))
    hashes["csr_spmv config 4"] = digest([tg._spmv(*ops)])
    times["csr_spmv config 4"] = cuda_ms(lambda: tg._spmv(*ops), 20)
    del g, ops
    torch.cuda.empty_cache()


def fingerprint_mst(gen, dev, digest, hashes, times):
    """mst_min_edge in --fingerprint: its triples hashed on the parity
    phase's hub graph (a 100,000-entry hub row, NaN pads, f32 and f64,
    int32 and int64 indptr, two colorings), then on the MST path's graph
    (bench_mst's R-MAT, built as mst_phase builds it) at every Borůvka
    round, each round timed; the mst call's forest and final colors hashed
    and the call timed."""
    import importlib

    import numpy as np
    import torch

    from raft_tpu_torch import device_resources
    from raft_tpu_torch.random import RngState, rmat_rectangular_gen
    from raft_tpu_torch.sparse.solver import mst_grid as tmg

    tmst = importlib.import_module("raft_tpu_torch.sparse.solver.mst")
    n = 20000
    for dtype in (torch.float32, torch.float64):
        indptr, indices, data = make_csr(gen, dev, n, n, max_len=40,
                                         hubs=[(7, 100000)], pad=5000,
                                         dtype=dtype)
        colorings = (torch.arange(n, device=dev),
                     torch.randint(0, 50, (n,), generator=gen, device=dev))
        for idx in (torch.int32, torch.int64):
            plan = tmg.MSTPlan(indptr=indptr.to(idx), indices=indices,
                               data=data.abs() + 0.01, n=n, n_cols=n,
                               n_edges=int(indptr[-1]))
            for i, colors in enumerate(colorings):
                hashes[f"mst_min_edge hub {dtype} {idx} coloring {i}"] = \
                    digest(tmg._min_edge(plan, colors.to(torch.int32)))
    res = device_resources(dev, seed=SEED)
    src, dst = rmat_rectangular_gen(res, RngState(SEED + 17), RMAT_SCALE,
                                    RMAT_SCALE, RMAT_EDGES)
    wgen = torch.Generator(device=dev).manual_seed(SEED + 18)
    w = torch.rand(src.shape[0], generator=wgen, device=dev) + 0.01
    g = csr_from_edges(src, dst, 1 << RMAT_SCALE, w)
    del src, dst, w
    plan = tmg.prepare_mst(g)
    c = torch.arange(plan.n, dtype=torch.int32, device=dev)
    for i in range(64):
        trip = tmg._min_edge(plan, c)
        hashes[f"mst_min_edge round {i}"] = digest(trip)
        times[f"mst_min_edge round {i}"] = cuda_ms(
            lambda: tmg._min_edge(plan, c), 10)
        c, _, _, n_incl = tmst._color_stage(c, plan, plan.n, *trip)
        if not int(n_incl):
            break
    colors = np.arange(plan.n, dtype=np.int32)
    forest = tmst.mst(res, g, color=colors)
    hashes["mst forest and colors"] = digest(
        [forest.src, forest.dst, forest.weights, torch.from_numpy(colors)])
    times["mst call"] = cuda_ms(lambda: tmst.mst(res, g), 3)
    del g, plan, forest
    torch.cuda.empty_cache()


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--fingerprint"]:
        check(len(sys.argv) == 3, "usage: chip_smoke.py --fingerprint ROOT")
        return fingerprint(sys.argv[2])
    from raft_tpu_torch import device_resources, kernels
    from raft_tpu_torch.kernels import build

    os.makedirs(OUT_DIR, exist_ok=True)
    dev = torch.device("cuda", 0)
    res = device_resources(dev, seed=SEED)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit("device", kind=kind, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         bound_peaks={"bf16_flops": PEAK_BF16_FLOPS,
                      "f32_flops": PEAK_F32_FLOPS, "bytes_per_s": PEAK_BYTES})

    t0 = time.perf_counter()
    built = build.build()
    hgmma = {name: hgmma_count(build, kernels, name)
             for name in ("pairwise_tile", "fused_argmin", "fused_lloyd",
                          "fused_topk", "minonly")}
    RECORD["build_logs"] = {n: b["log"] for n, b in built.items()}
    emit("unexpanded_sass", f32_kernels=unexpanded_sass(build, kernels),
         bound_instr_per_element=UNEXP_INSTR)
    ptxas = "\n".join(b["log"] for b in built.values())
    emit("build", seconds=time.perf_counter() - t0,
         kernels={n: round(b["seconds"], 2) for n, b in built.items()},
         max_registers=max(map(int, re.findall(r"Used (\d+) registers",
                                               ptxas)), default=None),
         spill_bytes=sum(map(int, re.findall(r"(\d+) bytes spill", ptxas))),
         hgmma=hgmma)

    parity_errs = parity(dev)
    parity_errs.update(topk_parity(dev))
    parity_errs.update(sparse_parity(dev))
    parity_errs.update(new_kernel_parity(dev))
    x, c, ops, launches, predict_ms = main_path(res, dev)
    lloyd_plan_phase(dev)
    topk_plan_phase(dev)
    argmin_plan_phase(dev)
    radix_plan_phase()
    small_fit_matches_cpu(res, dev)
    pairwise_phase(res, dev)
    unexp_launches, unexp_err = unexpanded_pairwise_phase(res, dev)
    table = kernel_numbers(x, c, ops, parity_errs, launches, predict_ms,
                           hgmma)
    del x, c, ops
    torch.cuda.empty_cache()
    db, q, knn_launches, _ = knn_path(res, dev)
    v_radix, v_ins, v_desc, v_asc, select_launches = select_path(res, dev)
    path_launches = {n: knn_launches.get(n, 0) + select_launches.get(n, 0)
                     for n in knn_launches}
    for name in ("fused_topk", "topk_insert", "radix_threshold",
                 "radix_emit"):
        check(path_launches[name] > 0, f"kNN and select_k paths never "
              f"launched {name}")
    topk_table, pairwise_chunk = topk_numbers(db, q, v_radix, v_ins, v_desc,
                                              v_asc, path_launches,
                                              parity_errs, hgmma)
    knn_k_sweep(db, q)
    next(r for r in table if r["name"] == "pairwise_tile")[
        "knn_chunk_shape"] = pairwise_chunk
    table += topk_table
    knn_unexp_launches, _ = unexpanded_knn_phase(res, dev, db, q)
    unexp_launches += knn_unexp_launches["unexpanded_tile"]
    for row in table:
        if row["name"] in ("radix_threshold", "radix_emit"):
            row["launches"] += knn_unexp_launches[row["name"]]
    unexp_row, l1_threshold, l1_emit = unexpanded_numbers(
        db, q, {"unexpanded_tile": unexp_launches},
        max(parity_errs["unexpanded_tile"], unexp_err))
    table.append(unexp_row)
    next(r for r in table if r["name"] == "radix_threshold")[
        "knn_l1_chunk_shape"] = l1_threshold
    next(r for r in table if r["name"] == "radix_emit")[
        "knn_l1_chunk_shape"] = l1_emit
    argmin_row = next(r for r in table if r["name"] == "fused_argmin")
    argmin_row["knn_shape"], probe_row = probe_phase(
        res, dev, db, q, parity_errs["minonly"], hgmma["minonly"])
    table.append(probe_row)
    del db, q, v_radix, v_ins, v_desc, v_asc
    torch.cuda.empty_cache()

    g, x, b16, c4, c4_launches = config4_phase(res, dev)
    part_launches, part_errs, argmin_row["partition_shape"] = \
        partition_phase(res, dev)
    argmin_row["partition_launches"] = part_launches["fused_argmin"]
    sparse_launches = {n: c4_launches[n] + part_launches[n]
                       for n in ("csr_spmv", "csr_spmm")}
    table += sparse_numbers(g, x, b16, sparse_launches, {
        n: max(parity_errs[n], c4["max_abs_err"][n], part_errs[n])
        for n in sparse_launches})
    del g, x, b16
    torch.cuda.empty_cache()
    _, mst_plan, mst_launches, mst_out = mst_phase(res, dev)
    table.append(mst_numbers(mst_plan, mst_launches,
                             mst_out["per_round_kernel_alone_ms"]))
    check(len(table) == len(kernels.REGISTRY)
          and {r["name"] for r in table} == set(kernels.REGISTRY),
          "the kernels line does not list every registered kernel")
    RECORD["kernels"] = table

    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(RECORD, f, indent=1)
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
