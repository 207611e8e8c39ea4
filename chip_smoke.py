#!/usr/bin/env python3
"""Quickest proof that raft_tpu_torch runs on a CUDA card.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit's ``nvcc`` and this checkout. It
builds the port's CUDA kernels from ``raft_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card at all three precision
tiers, drives the main path — k-means (Lloyd) on 1,000,000 x 128 f32
with k = 1024 at tier 'high', then the distance embedding of the data —
and times every kernel at the shapes that path gives it. Each phase
prints one JSON line; the line before the last is the card's name and
power limit from ``nvidia-smi``, the last is the result. Longer output
(compiler logs, all numbers) goes to ``chiprun_out/chip_smoke.json``.
Any failed check raises, and the script exits non-zero; without CUDA it
exits non-zero before printing any result.
"""

import json
import os
import re
import subprocess
import sys
import time

SEED = 20261016
MAIN_M, MAIN_K, MAIN_N, MAIN_ITERS = 1_000_000, 128, 1024, 10
PAIRWISE_M, PAIRWISE_K = 5000, 50          # BASELINE config 1
REL = 1e-5            # bf16x3 / f32 agreement between two f32 summation orders
# H100 SXM peaks at 700 W (dense bf16 tensor-core rate, HBM3 bandwidth)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
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
    mb = 2 * tc.LLOYD_BLOCKS * tc.TILE_M + 77   # Lloyd rows: ~2 tiles a block
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
        # (three and two row tiles a block), which must give the same labels
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
                check(torch.equal(out[3], first[3])
                      and torch.equal(out[2], first[2])
                      and torch.equal(out[1], first[1]),
                      f"{what}: labels, distances or counts changed with "
                      "the grid")

        # the full persistent grid with several row tiles a block and a
        # ragged last tile, as at the main shape
        xbs = tc._side(xb, tier)
        check(-(-mb // tc.TILE_M) > tc._lloyd_blocks(mb, n, k, tier),
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
    for name, count in launches.items():
        check(count > 0, f"main path never launched {name}")
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

    # steady-state iteration time on the prepared operands
    with tprec.scope("high"):
        ops, meta = tk.lloyd_prepare(x, MAIN_N)
        it_ms = cuda_ms(lambda: tk.lloyd_step_prepared(ops, c, **meta), 5)
    emit("main_path", shape=[MAIN_M, MAIN_K], n_clusters=MAIN_N,
         tier="high", n_iter=n_iter, inertia=float(inertia),
         start_cost=start_cost, wall_s=wall, ms_per_iter=it_ms,
         iters_per_s=1000.0 / it_ms, embedding_argmin_agreement=agree,
         launches=launches)
    return x, c, ops, launches


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
        launches = kernels.launch_counts()
        check(launches == {"pairwise_tile": 1, "fused_argmin": 0,
                           "fused_lloyd": 0},
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


def kernel_numbers(x, c, ops, parity_errs, launches):
    """Each kernel at the main-path shapes, at every tier: held against
    its plain version, then timed beside it, beside a one-call PyTorch
    yardstick (timed here only; the port never calls it) and beside its
    bound. The main path's tier ('high') fills the kernel's row."""
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
                    label_agreement=agree, differing_labels=(
                        None if agree is None else bad.numel()),
                    sums_err_over_mass=sums_rel)
                torch.cuda.empty_cache()
            high = by_tier["high"]
            spec = kernels.REGISTRY[name]
            table.append({
                "name": name, "route": "cuda",
                "source": f"raft_tpu_torch/{spec.source}",
                "replaces": spec.replaces, "launches": launches[name],
                "max_abs_err": max(high["max_abs_err"], parity_errs[name]),
                "ms": high["ms"], "plain_ms": high["plain_ms"],
                "bound_ms": high["bound_ms"], "bound_by": high["bound_by"],
                "library_ms": (None if case["library"] is None
                               else cuda_ms(case["library"], 3)),
                "library_call": case["library_call"], "parity": "pass",
                "differing_labels": high["differing_labels"],
                "sums_err_over_mass": high["sums_err_over_mass"],
                "shape": [m, n, k], "tier": "high",
                "other_tiers": {t: by_tier[t] for t in ("default",
                                                        "highest")}})

        # the k-means|| candidate weighting: ~10k candidates against X
        n2 = 10240
        cand = x[torch.randperm(m, device=x.device)[:n2]]
        xs = tc.Side(ops[0], ops[1], ops[2].reshape(-1))
        cs = tc._side(cand, "high")
        b, by = bound("high", m, n2, k, 8 * m)
        table[1]["candidate_shape"] = dict(
            shape=[m, n2, k], tier="high", bound_ms=b, bound_by=by,
            ms=cuda_ms(lambda: tc._fused_argmin("high", "l2", xs, cs, m, n2,
                                                k), 2),
            plain_ms=None)           # the plain version needs m x n2 f32
    return table


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from raft_tpu_torch import device_resources
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
    RECORD["build_logs"] = {n: b["log"] for n, b in built.items()}
    ptxas = "\n".join(b["log"] for b in built.values())
    emit("build", seconds=time.perf_counter() - t0,
         kernels={n: round(b["seconds"], 2) for n, b in built.items()},
         max_registers=max(map(int, re.findall(r"Used (\d+) registers",
                                               ptxas)), default=None),
         spill_bytes=sum(map(int, re.findall(r"(\d+) bytes spill", ptxas))))

    parity_errs = parity(dev)
    x, c, ops, launches = main_path(res, dev)
    small_fit_matches_cpu(res, dev)
    pairwise_phase(res, dev)
    table = kernel_numbers(x, c, ops, parity_errs, launches)
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
