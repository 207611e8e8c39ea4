#!/usr/bin/env python3
"""Quickest proof that raft_tpu_torch runs on a CUDA card.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit's ``nvcc`` and this checkout. It
builds the port's thirteen CUDA kernels from ``raft_tpu_torch/csrc``
(one ``nvcc`` each, all at once), holds each against its plain PyTorch
version on the card (the contraction kernels at all three precision
tiers, the selection kernels at ragged shapes with ties, NaN and inf,
the unexpanded tile at every metric in f32, bf16 and f64 with zero, NaN
and inf entries, the MST E-stage on a 100,000-entry hub row under four
colorings, the 1-NN probe over many database splits), and drives these
paths, each with the launch counts set to 0 just before it and read
just after:

- the guard modes (the ``guards`` line, at tier 'high'): for
  ``pairwise_distance``, ``gemm`` and ``spmv``, 'off' and a passing
  'check' or 'recover' give the same bits, a NaN operand raises
  ``NonFiniteError`` with stage 'input' and an overflow from finite
  operands stage 'output' under both modes ('recover' after its re-run
  one tier up); ``cholesky_r1_update`` raises ``IllConditionedError`` on a
  non-PSD update and, under 'recover', rescues an f32 cancellation to
  the f64 factor; ``eig_jacobi`` at its sweep limit escalates to the f64
  eigh under 'recover'; ``kmeans_fit``'s chunk sentinel raises on an
  inertia that overflowed; a check inside a CUDA graph capture reads
  nothing; ``finite_sentinel`` timed on 1M x 1024 f32 beside its bound;
- k-means (Lloyd) on 1,000,000 x 128 f32 with k = 1024 at tier 'high',
  then the distance embedding of the data;
- the compiled driver (the ``compiled_driver`` line) at config 3:
  ``kmeans_fit`` with ``sync_every=1`` (the host loop) against the
  default (the cost model's chunk on the card, 8 iterations here: a
  first chunk of steps launched one by one, then chunks replaying a
  captured CUDA graph of one step, one host read a chunk), 10
  iterations at tol 0, at a tol that converges mid chunk and at the
  default tol (bitwise equal centroids, labels and ``n_iter``; the host
  syncs ``solver_host_syncs_total`` one a chunk; the same launches per
  kernel, replays counted; ms an iteration from fits of two and four
  chunks; each fit's idle share, device ops and top-level torch ops
  from a trace; the steps launched against the steps that ran; the
  default-tol fits' ms; a masked replay's ms; 24 fits of two chunks
  timed one by one, for the captures' stalls); then
  ``kmeans_partial_fit`` over the 1M rows from the same centroids at
  ``chunk_rows`` 256 and 4096, host loop against captured (bitwise,
  counts summing to the rows, a host read a chunk, equal launches, ms
  and torch ops a chunk), the first 65,536 rows against the same pass on
  the CPU (centroids within REL, labels but at near-ties; where a label
  at a near-tie parts the passes, the step it parts at must be a
  near-tie), and a resume from a mid-batch ``kmeans_pf`` checkpoint
  under ``chiprun_out/`` bitwise the whole run (removed after);
- pairwise_distance at BASELINE config 1's 5000 x 50 (the port's
  ``random.make_blobs``, 10 centers): the five expanded metrics and the
  seven unexpanded ones;
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
  one SpMM at k = 16 and the fixed 3-restart Lanczos (52 steps); the
  gated ``csr_spmv`` (gated on: the ungated kernel's bits; gated off: it
  writes nothing); ``eigsh`` over 16 outer iterations (tol 0) at
  ``sync_every`` 1, the default and 8 (captured chunks), bit for bit
  with the same launches and one host read a chunk, ms a solve and a
  restart; and ``sym_eig_jacobi`` (the Ritz solve) on the first
  extension's projected matrix against its plain version and cuSOLVER's
  ``eigh``;
- spectral partition of a planted 4-block graph of the same size, then
  both analyzers: the blocks must be recovered (agreement >= 0.99, edge
  cut within 1% of the planted one) with a converged Lanczos;
- Borůvka MST on bench_mst's graph (R-MAT scale 20, 10M edges, random
  weights): n - n_components forest edges, the f64 total weight equal to
  scipy's, and forest and colors equal to the plain E-stage's;
- BASELINE config 2, the dense linalg path (bench_prims.py:236-257), on
  16,384 x 1024 f32 (the ``config2`` line): the gram gemm at each tier
  against an f64 product over |a|ᵀ|a|, with TF32 turned on around the
  calls (gemm must turn it off; 'high' within REL), beside f32 cuBLAS
  and bf16x3 taken in one call over the whole depth; row norms and
  normalize; ``svd_eig`` and ``svd_qr`` against the f64 singular values,
  each reconstructing the matrix; ``rsvd_fixed_rank`` at k = 64 on a
  planted spectrum; ``eig_dc``, ``eig_sel`` (top 16, its route) and
  ``eig_jacobi`` on the Gram matrix against an f64 eigh (and two sweeps
  of its rotations as paired row and column updates, timed); the three lstsq routes with a 1024-column b against an f64
  lstsq; PCA (both solvers), truncated SVD and the incremental fit in
  2048-row chunks against the monolithic fit, and that fit at
  ``sync_every`` 1, the default and 4 bit for bit; and the keyed sums
  (``reduce_rows_by_key``, 1024 keys, weighted and not;
  ``reduce_cols_by_key``, 64 column keys) through ``csr_spmm``, held
  against its plain version, an f64 sum and timed beside cuSPARSE;
- the comms layer on a NCCL process group of world size 1: every
  ``perform_test_comms_*`` self-test and ``perform_test_comm_split`` on
  CUDA tensors (each must return True), then BASELINE config 5 at full
  width (10,000,000 x 256 f32, k = 4096, tier 'high'): 3 iterations of
  ``mnmg_lloyd_step`` over the one-rank data axis, bitwise equal to 3 of
  ``lloyd_step`` from the same centroids, with the all-reduces' share of
  the step; the model-axis branch at the k-means shape above on a (1, 1)
  mesh (``lloyd_step``'s labels exactly, its centroids to 1e-5); and a
  NaN database row through every kNN route on the card against the same
  calls on the CPU (indices equal, values equal or both NaN);
- the MNMG solvers through their entry points on that group (the
  ``mnmg_fit`` line): config 5 through ``kmeans_fit_mnmg`` at its
  default ``sync_every`` (the host loop; 4 iterations, tol 0, a
  checkpoint each under ``chiprun_out/``), bitwise
  equal to 4 ``mnmg_lloyd_step``s and the final re-assign, with
  ``kmeans_fit``'s ``n_iter``, and resumed from its iteration-2
  checkpoint bitwise the same; the same fit at ``sync_every`` 2 (its
  second chunk a captured graph with the all-reduce inside) bitwise the
  host loop's, its chunk-boundary checkpoints holding the host loop's
  centroids; ``knn_mnmg`` at the kNN shape (l2 at
  k = 64 through the fused kernel; inner and l1 at k = 64 on 256 queries
  through the scan) against ``knn``, and the l2 pad rows at 1e15 never
  ranking in at 'high'; ``eigsh_mnmg`` on config 4's normalized
  Laplacian (k = 4, ``ncv`` 20, 3 restarts) against the single-device
  solver's eigenvalues within 1e-4, and over 6 outer iterations at
  ``sync_every`` 1 and 2 bit for bit, every chunk-boundary checkpoint
  equal to the host loop's; and ``partition(mesh=...)`` on the
  planted graph, at the single-device partition's bar;
- IVF at the reference's bench families' full shapes
  (``bench_prims.py:1163-1262``; the ``ivf`` line, 'high'): IVF-Flat on
  2^20 x 64 f32 blobs, 1024 lists (``kmeans_fit``, 10 iterations), 256
  queries, k = 10 at nprobe 1, 4, 16 and 1024 and k = 64 at nprobe 16
  (the radix route), with recall@k against ``knn``, the full probe
  bitwise ``knn``, recall@10 at nprobe 16 at least 0.95, nprobe 16 at
  k = 10 and 64 on 64 queries against the same search on the CPU, and
  extends on both branches bitwise a rebuild; IVF-PQ on 2^20 x 128,
  1024 lists (a flat build's centroids), m = 16, nbits 8: the build's
  parts, the (nprobe, refine) sweep, the compression ratio (at least 8),
  the full probe bitwise ``knn`` on ``raw()``, (16, 0) and (16, 40) on
  64 queries against the CPU, the one-hot and gather LUT sums bitwise,
  and the encode's ``fused_argmin`` and the codebooks' ``fused_lloyd``
  at [65,536 x 8] x [256 x 8] against their plain versions; each
  search's launches, and the device memory of the nprobe 16 searches
  against the work budget's estimate (``ivf_memory`` lines); and, in
  the NCCL group, ``search_mnmg`` at 2^18 x 64, 256 lists, nprobe 16,
  k = 10 and 64, bitwise ``ivf_flat.search``, ``search_local`` +
  ``merge_pool`` bitwise ``search_mnmg``, and ``shrink_mnmg`` to one
  survivor equal to a fresh ``build_mnmg``;
- the serving executor (the ``serve`` line, right after ``ivf``, at
  'high'): ``KnnService`` k = 64 (fused) and k = 1024 (radix) on the
  kNN database, ``PairwiseService`` L2 and L1 on config 1's corpus,
  ``KMeansPredictService`` on config 3's centroids, ``IvfKnnService``
  and ``IvfPqKnnService`` (k = 64, nprobe 16) on the ivf phase's
  indexes; one exported program a (service, bucket) from 8 to 256 rows
  built by ``warm()``, then three tenants (4 : 2 : 1) sending requests
  of 1–64 rows drawn from the seed through ``BatchPolicy(256, 2 ms)``:
  every result bitwise its eager call, no build, export or capture
  after ``warm()``, each service's kernels launched, the brute-force,
  pairwise and predict services on exported programs; a 1 ms deadline
  behind a full batch fails with ``DeadlineExceededError``; budgets
  under the 256-row bucket's estimate split a coalesced batch and
  degrade a lone 256-row request (``knn``'s capped tile at k = 64 and
  1024, ``pairwise_distance``'s row blocks), bitwise, and a budget
  under the operands rejects; median launch ms by bucket, latency p50
  and p99, the coalescing factor, the fallbacks, ``warm()`` seconds;
- the serving fleet (the ``serve_fleet`` line, right after ``serve``,
  at 'high', on the kNN database shared by every replica and level):
  three executors behind a ``ReplicaGroup`` (``KnnService`` k = 64,
  buckets 8..64, a ``FaultInjector`` each), one executor's and the
  fleet's closed-loop rates, open-loop arrivals at 25/50/75/90% of the
  fleet's, the duty-cycled slow replica without and with hedging, a
  replica killed mid spike and the write leader killed; a
  ``BrownoutController`` over ``knn_ladder(db, [64, 32, 16])``: its
  executor's closed-loop rate at level 0, the traffic step from a
  quarter of that rate to four times it and back, and the hog tenant,
  every tenant under a 25 ms SLO; a floor violation flight-recorded
  as ``BrownoutFloorError``, and both that ladder and an ``ivf_ladder``
  (nprobe 16/8/4 on the ivf phase's IVF-Flat index) driven into each
  level once; 500 responses a scenario chosen by the seed, every hedge
  leg and hedged response, each bitwise its eager call at its stamped
  level; no build, export or capture after ``warm()``; the hedge rate
  within its 5% budget; every future of a killed replica resolved; the
  recovery to the SLO finite; ``fused_topk`` and the radix kernels
  launched;
- the streaming index (the ``streaming`` line, after ``serve_fleet``,
  at the ivf phase's 2^20 x 64 with 1024 lists, 'high', journaled under
  ``chiprun_out/streaming``, removed after): ``stream_build`` and a
  provisioning compaction; fitting inserts of 4096 rows next to their
  centroids (every snapshot shape kept) and one of 65,536 that
  overflows into an epoch; 10% of the ids deleted; 256 queries at
  nprobe 16, k = 10 and k = 64 (the radix route), bitwise the search of
  a rebuild of the live rows on the same centroids, and the full probe
  bitwise ``knn`` over them; the compaction (``content_crc()`` and the
  bits kept); shifted rows until the drift gauge fires, and the refit
  (centroids moved, every id kept, its chunk checkpoints written);
  recovery on the card (the CRC and the search bits) and on the host
  (the CRC); the scrubber's clean pass, a corrupted epoch file
  quarantined and written again from memory, one byte of the packed
  rows flipped on the card and repaired from the recovered twin; an
  ``IngestController`` over the k = 10 and k = 64 services (buckets
  8..64): a same-shape swap served at once, then ``streaming_loop``
  once an op, every response the seed chose (at least 500 in all)
  bitwise an eager search of a snapshot of its window, the recall
  floor, no build, export or capture on the query path after
  ``warm()``; ``fused_argmin``, ``fused_lloyd``, ``fused_topk`` and the
  radix kernels launched;
- AOT artifacts (the ``aot`` line): ``lloyd_step`` at config 3's shape
  and ``radix_select_k`` at the select shape exported, saved with the
  sha256 sidecar, loaded and run in a fresh ``python`` process bitwise
  the eager calls with no ``nvcc`` run there; export, save and load
  seconds;
- C5's cost (the ``c5`` line, in the config 2 phase): gemm's 'high' at
  the gram through the dot split against the kernel split in turns
  (the bits equal), and the inf and 3.4e38 probes through gemm,
  ``InnerProduct`` and SDDMM on the card; the operators' dispatch (the
  ``operator_overhead`` line, after config 4): ``csr_spmv`` at config 4
  through ``torch.ops.raft_tpu_torch.csr_spmv`` against a direct
  ``ctypes`` launch in turns, device ms and the host's µs a call;
- the stats path (the ``stats`` line), the cuML evaluation workflow at
  config 3's shape: ``random.make_blobs`` 1,000,000 x 128 f32, 1024
  centers (exact round-robin counts, the noise's per-cluster means within
  6 sigma and its std within 1%), ``cluster.kmeans_fit`` on it (k = 1024,
  'high', 10 iterations from k-means||), the six external scores of the
  fit against the blobs' labels (within 1e-12 of f64 numpy), ``meanvar``
  and ``cov`` (within REL of f64), histograms of the labels and, through
  a binner, of the data at 20,000 bins (equal to ``np.bincount``); on a
  65,536-row ``matrix.sample_rows`` sample, ``silhouette_score`` (the
  unexpanded tile's distances, ``csr_spmm``'s keyed sums; within 1e-5 of
  f64, its time split into the two), ``trustworthiness_score`` of a
  16-component PCA embedding (the unexpanded tile, the insertion top-k;
  within 1e-7 of f64), each of those kernels against its plain version
  at one chunk's or block's shape (the numbers go to their rows of the
  kernels line as ``stats_shapes``), ``neighborhood_recall`` of ``knn`` at
  'default' against 'highest'; and ``label.merge_labels`` of the fit's
  and the blobs' labels over all 1M rows (every row and 1% masked) equal
  to scipy's components, with its rounds;
- the primitives path (the ``primitives`` line; no registry kernel runs
  there, so every launch count must stay 0): the auction LAP solver on
  cuGraph's dense_hungarian shape (1 x 1024 x 1024 integral costs,
  total equal to scipy's), 64 x 256 x 256 uniform problems (each within
  n·eps of scipy's optimum and of its dual) and 1 x 4096 x 4096, the first
  two bit for bit the port's CPU run (16 of the 64 lanes), with rounds a
  phase, syncs and ms a round beside a round's read of the costs; the
  device vector cache at cuML SVC's default 1024 MiB (16,384 columns of
  16,384 f32 rows, associativity 32) fed 512-key insert and lookup
  batches with reuse, hits, vectors and the final state equal to the same
  sequence on the CPU; a 1M x 128 f32 matrix device -> pinned host ->
  device through ``core.mdarray`` (bitwise, GB/s beside PCIe Gen5 x16),
  ``core.serialize`` of it and of its bf16 rounding against ``np.save``,
  the native runtime's ``npy_save`` bytes against ``dumps``, its
  ``parallel_copy`` beside ``np.copyto``; the handle's memory stats, the
  architecture query (sm_90), ``matmul_escalation`` of a gemm at
  'default' (the 'high' bits), and ``DeviceResourcesSNMG`` over the one
  card with its comms self-tests;
- the rest of sparse and the compat layer (the ``sparse_compat`` line,
  after the NCCL phases, on config 4's graph): ``sparse.weak_cc`` equal
  to scipy's weak components (each labelled 1 + its smallest vertex),
  with its rounds (a host read each) and ms; 10% of the vertices
  masked, equal to scipy's components of the kept subgraph and to the
  same call on the CPU;
  ``weak_cc_mnmg`` on a NCCL group of world size 1 bitwise ``weak_cc``;
  the CSR ``select_k`` on 65,536 rows of 0..512 entries at k = 32, min
  and max, through the radix kernels, the insertion kernel and AUTO
  (torch's top-k at this width), each bit for bit the dense ``select_k``
  over the same padded rows; ELL spmv and spmm (k = 16) on 65,536 rows
  of 32 entries against ``csr_spmv`` and ``csr_spmm`` within the sparse
  tolerance; ``sddmm`` and ``masked_matmul`` (a Bitmap of that pattern)
  with A [65,536 x 128] at each tier against f64 dots on 65,536 sampled
  entries; ``compat.eigsh`` bitwise ``eigsh`` on config 4's graph (3
  restarts), ``compat.rmat`` into an ``out=`` ``device_ndarray`` bitwise
  ``rmat_rectangular_gen`` at config 4's scale, and a ``device_ndarray``
  through ``__cuda_array_interface__`` and DLPack without a copy. The
  CSR select_k's and ``compat.eigsh``'s launches are counted.

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
``radix_emit``, ``csr_spmv``, ``csr_spmm`` and ``mst_min_edge`` on seeded
inputs, and of the kNN, select_k and mst calls that run the radix and MST
kernels, and times them at the main paths' shapes, from the
``raft_tpu_torch`` package under ROOT: run on this checkout and
on another commit's package in turns, it shows whether a change kept
those kernels bit for bit, and their times.
"""

import json
import os
import re
import subprocess
import sys
import time
import warnings
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
# BASELINE config 2 (bench_prims.py:236-257): the dense linalg path
C2_M, C2_N = 16384, 1024
TIERS = ("default", "high", "highest")
C2_RSVD_K, C2_RSVD_DECAY = 64, 0.9      # planted s_i = 0.9^i for rsvd
C2_PCA_K, C2_PCA_DECAY = 64, 0.99       # planted s_i = 0.99^i for PCA
C2_CHUNK = 2048                         # pca_partial_fit's chunk rows
C2_SEL_K = 16                           # eig_sel: the iterative route
C2_KEYS, C2_COL_KEYS = 1024, 64         # reduce_rows/cols_by_key
# eig_jacobi at the reference's tol and sweeps; f32 Jacobi with the
# reference's rotation formula keeps eigenvalues to about 2e-5 of the
# largest at n = 128 (1.5e-5 the reference, 2.1e-5 the port, on the CPU),
# and its rounding grows with the rotations: a few 1e-4 at n = 1024
C2_JACOBI_TOL, C2_JACOBI_SWEEPS, C2_JACOBI_REL = 1e-7, 15, 1e-3
# tolerances, relative to the largest reference value (rsvd: each value)
C2_SVD_REL, C2_EIG_REL, C2_LSTSQ_REL, C2_RSVD_REL = 1e-4, 1e-5, 1e-4, 1e-4
C2_PCA_ATOL = 1e-4                      # partial fit's components
# the reference's IVF bench families at full size (bench_prims.py:1163-1262):
# neighbors/ivf_recall, neighbors/ivf_pq_recall, neighbors/ivf_mnmg_scaling
IVF_N, IVF_Q, IVF_D, IVF_LISTS, IVF_ITERS = 1 << 20, 256, 64, 1024, 10
IVF_RADIX_K = 64                        # k > 16 over >= 8192 candidates
IVF_FLAT_SEARCHES = ((10, 1), (10, 4), (10, 16), (10, IVF_LISTS),
                     (IVF_RADIX_K, 16))
IVF_RECALL_FLOOR = 0.95                 # tests/test_ivf_flat.py:106-117
IVF_CPU_Q = 64                          # queries held against the CPU
IVF_EXTEND = 4096                       # rows of the repacking extend
PQ_D, PQ_M, PQ_NBITS, PQ_ITERS = 128, 16, 8, 10
PQ_FULL = (IVF_LISTS, 40)               # full probe, refine 4k
PQ_SWEEP = ((1, 0), (4, 0), (16, 0), (16, 40), PQ_FULL)
PQ_LUT_Q = 16                           # queries of the LUT-sum check
PQ_CHUNK = 1 << 16                      # ivf_pq._ENCODE_CHUNK
MNMG_IVF_N, MNMG_IVF_LISTS, MNMG_IVF_NPROBE = 1 << 18, 256, 16
# the stats phase: make_blobs at config 3's shape, the fit, its scores
STATS_M, STATS_D, STATS_K = MAIN_M, MAIN_K, MAIN_N
STATS_SAMPLE, STATS_EMB, STATS_NN, STATS_BATCH = 65536, 16, 10, 512
STATS_HIST_BINS = 20000
# the sample scores against f64: about 100x the H100 gaps (silhouette
# 8e-8, trustworthiness 3e-10; a trustworthiness rank unit is 2.3e-11)
STATS_SIL_TOL, STATS_TRUST_TOL = 1e-5, 1e-7
# the primitives phase: cuGraph's dense_hungarian (one 1024 x 1024
# problem), many small tracking problems, one 4096 x 4096; cuML SVC's
# kernel cache at its default cache_size (1024 MiB: 16,384 columns of
# 16,384 f32 rows, associativity 32); a 1M x 128 f32 matrix's host trips
LAP_A, LAP_B, LAP_C = (1, 1024), (64, 256), (1, 4096)
LAP_B_CPU_LANES = 16                    # (b)'s lanes re-run on the CPU
LAP_COST_MAX = 1000                     # (a): integral costs in [0, 1000)
CACHE_ROWS, CACHE_COLS, CACHE_ASSOC = 16384, 16384, 32
CACHE_BATCH, CACHE_KEYS, CACHE_STEPS = 512, 2 * CACHE_COLS, 16
XFER_M, XFER_D = 1 << 20, 128
PCIE5_X16_BYTES = 63.0e9    # 32 GT/s x 16 lanes, 128b/130b, one direction
# the sparse_compat phase: weak_cc on config 4's graph (10% of vertices
# masked in its second run), the CSR select_k on 65,536 rows of 0..512 entries at k = 32,
# ELL and SDDMM on 65,536 rows of 32 entries (A [65,536 x 128])
WCC_MASKED = 0.1
SC_ROWS, SC_MAX_LEN, SC_COLS, SC_K = 65536, 512, 1 << 20, 32
ELL_ROWS, ELL_WIDTH, SDDMM_K, SDDMM_SAMPLE = 65536, 32, 128, 65536
# SDDMM against f64 dots, relative to sum |a_k b_k|: two f32 orders
# (REL) at 'highest' and 'high'; one bf16 pass about 2^-8 an operand
SDDMM_REL = {"highest": REL, "high": REL, "default": 1e-2}
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


def median_ms(fn, reps):
    """Median device milliseconds of one ``fn()`` over ``reps`` runs after
    one warm-up run (CUDA events around each run): a run that captures a
    CUDA graph may stall on the host now and then, and the median keeps
    such a run from setting the figure."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
        events, runtime, _ = device_trace(step, reps)
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
# compiled_driver: kmeans_fit's chunks and kmeans_partial_fit as captured
# CUDA graphs against the host loop
# ---------------------------------------------------------------------------

CD_CHUNK_ROWS = (256, 4096)     # kmeans_partial_fit's default, and a wide one
CD_CPU_ROWS = 65536             # rows of the partial fit held to the CPU
CD_HISTORY = 40                 # iterations of the mid-chunk tol's history
CD_RESUME_AT = 128              # chunk of the mid-batch checkpoint
CD_STALL_FITS = 24              # fits of two chunks timed one by one


def cd_trace(fn, reps):
    """``device_trace`` of ``reps`` calls of ``fn``, a call: the card's
    idle share, busy and span ms, device ops, top-level torch ops and
    runtime calls."""
    events, runtime, aten = device_trace(fn, reps)
    span = max(e for _, _, e in events) - min(s for _, s, _ in events)
    busy = busy_us(events)
    return dict(idle_share=1.0 - busy / span,
                busy_ms=busy / reps / 1e3, span_ms=span / reps / 1e3,
                device_ops=len(events) / reps, aten_ops=aten / reps,
                runtime_calls={k: v / reps for k, v in runtime.items()})


def cd_default_sync(dev, m):
    """The ``sync_every`` a k-means step over ``m`` rows at config 3's
    width resolves to on the card (the cost model with the step's
    estimated seconds, as ``kmeans_fit`` and ``kmeans_partial_fit`` ask
    it)."""
    from raft_tpu_torch.runtime import compiled_driver as cdrv
    from raft_tpu_torch.runtime import limits

    est = limits.estimate_seconds("cluster.lloyd_step", backend="gpu",
                                  m=m, k=MAIN_K, n_clusters=MAIN_N,
                                  itemsize=4)
    return cdrv.resolve_sync_every(None, step_seconds=est, device=dev)


def cd_counts(op):
    """``solver_host_syncs_total`` of ``op`` in the live registry."""
    from raft_tpu_torch import obs

    fam = obs.get_registry().snapshot().get("solver_host_syncs_total")
    return sum(s["value"] for s in (fam or {}).get("series", [])
               if s["labels"].get("op") == op)


def cd_run(fn):
    """``fn()`` with the launch counts, the graph counts and (metrics
    on) a fresh metrics registry: ``(out, launches, graph counts, wall
    s)``."""
    import torch

    from raft_tpu_torch import kernels, obs
    from raft_tpu_torch.obs import metrics as obs_metrics
    from raft_tpu_torch.runtime import compiled_driver as cdrv

    if obs.enabled():
        obs_metrics.set_registry(obs.MetricsRegistry())
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    g0 = cdrv.graph_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    g1 = cdrv.graph_stats()
    return (out, kernels.launch_counts(),
            {k: g1[k] - g0[k] for k in g0}, wall)


def cd_fit_part(res, dev, x, c0, sync):
    """(a): config 3 through ``kmeans_fit`` at ``sync_every=1`` and at
    the default (captured chunks), tol 0, a tol that converges mid
    chunk and the default tol; bitwise equal, host syncs one a chunk,
    equal launches; ms an iteration, a masked step's ms and a
    default-tol fit's ms; CD_STALL_FITS fits of two chunks one by one
    (a capture's stalls)."""
    import math
    import statistics

    import torch

    from raft_tpu_torch.cluster import kmeans as tk
    from raft_tpu_torch.util import precision as tprec

    op = "cluster.kmeans_fit"

    def fit(max_iter, tol, s):
        # tol None: KMeansParams' defaults (max_iter 300, tol 1e-4)
        kw = {} if tol is None else dict(max_iter=max_iter, tol=tol)
        p = tk.KMeansParams(n_clusters=MAIN_N, init=tk.KMeansInit.ARRAY,
                            **kw)
        with tprec.scope("high"), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # unconverged
            return tk.kmeans_fit(res, p, x, c0, sync_every=s)

    fit(MAIN_ITERS, 0.0, None)   # warm-up
    runs = {}
    for name, s in (("eager", 1), ("captured", None)):
        out, launches, graphs, wall = cd_run(
            lambda: fit(MAIN_ITERS, 0.0, s))
        runs[name] = dict(out=out, launches=launches, graphs=graphs,
                          host_syncs=cd_counts(op), wall_s=wall)
    (ce, _, le, ne), (cc, _, lc, nc) = (runs["eager"]["out"],
                                        runs["captured"]["out"])
    check(ne == nc == MAIN_ITERS, f"compiled_driver: n_iter {ne} / {nc}")
    check(torch.equal(ce, cc) and torch.equal(le, lc),
          "compiled_driver: captured kmeans_fit not bitwise the host loop")
    check(runs["eager"]["launches"] == runs["captured"]["launches"],
          f"compiled_driver: launches {runs['eager']['launches']} vs "
          f"captured {runs['captured']['launches']}")
    check(runs["captured"]["host_syncs"] == math.ceil(MAIN_ITERS / sync)
          == runs["captured"]["graphs"]["host_reads"],
          f"compiled_driver: {runs['captured']['host_syncs']} host syncs "
          f"for {MAIN_ITERS} iterations at sync_every={sync}")
    check(runs["captured"]["graphs"]["steps_launched"] == MAIN_ITERS,
          f"compiled_driver: {runs['captured']['graphs']} for "
          f"{MAIN_ITERS} steps")
    out = dict(sync_every=sync, n_iter=nc,
               launches=runs["captured"]["launches"],
               host_syncs={"eager": MAIN_ITERS,
                           "captured": runs["captured"]["host_syncs"]},
               graphs=runs["captured"]["graphs"])
    # ms an iteration: a fit of 4 chunks less a fit of 2 (each captures
    # once, at its second chunk), over 2 chunks (tol -1: no fit stops
    # early)
    for name, s in (("eager", 1), ("captured", None)):
        two = median_ms(lambda: fit(2 * sync, -1.0, s), 5)
        four = median_ms(lambda: fit(4 * sync, -1.0, s), 5)
        tr = cd_trace(lambda: fit(2 * sync, -1.0, s), 2)
        tr["device_ops"] /= 2 * sync
        tr["aten_ops"] /= 2 * sync
        out[name] = dict(fit_ms={2 * sync: two, 4 * sync: four},
                         ms_per_iter=(four - two) / (2 * sync),
                         trace_per_iter=tr)
    out["bound_ms_per_iter"] = 2.0 * MAIN_M * MAIN_N * MAIN_K * 3 \
        / PEAK_BF16_FLOPS * 1e3
    # a capture now and then stalls the host: CD_STALL_FITS fits of two
    # chunks each (a capture each when chunked), host clock, one by one
    for name, s in (("eager", 1), ("captured", None)):
        walls = []
        for _ in range(CD_STALL_FITS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit(2 * sync, -1.0, s)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(walls)
        out[name]["fits_of_two_chunks"] = dict(
            fits=len(walls), median_ms=med, max_ms=max(walls),
            over_twice_the_median=[w for w in walls if w > 2 * med])
    # a tol that converges mid chunk: the host loop's relative changes
    with tprec.scope("high"):
        ops, meta = tk.lloyd_prepare(x, MAIN_N)
        c, prev, rels = c0, None, []
        for _ in range(CD_HISTORY):
            c, inertia, _ = tk.lloyd_step_prepared(ops, c, **meta)
            cur = float(inertia)
            rels.append(float("inf") if prev is None
                        else abs(prev - cur) / max(prev, 1e-30))
            prev = cur
        del ops, c
    at = next((i for i in range(sync + 1, CD_HISTORY + 1)
               if i % sync and rels[i - 1] < min(rels[:i - 1])), None)
    check(at is not None, f"compiled_driver: no mid-chunk convergence "
          f"point in {rels}")
    tol = rels[at - 1]
    conv = {}
    for name, s in (("eager", 1), ("captured", None)):
        res_, launches, graphs, _ = cd_run(lambda: fit(CD_HISTORY, tol, s))
        conv[name] = (res_, launches, graphs)
    (ce, _, le, ne), (cc, _, lc, nc) = conv["eager"][0], conv["captured"][0]
    check(ne == nc == at, f"compiled_driver: tol {tol} converged at "
          f"{ne} / {nc}, want {at}")
    check(torch.equal(ce, cc) and torch.equal(le, lc),
          "compiled_driver: mid-chunk convergence not bitwise")
    launched = conv["captured"][2]["steps_launched"]
    check(launched == -(-at // sync) * sync,
          f"compiled_driver: {launched} steps launched for {at}")
    out["mid_chunk"] = dict(tol=tol, n_iter=nc, steps_launched=launched,
                            steps_ran=nc)
    out["masked_step"] = cd_masked_step(x, c0, sync)
    # the default tol: bitwise, and each fit's ms, the captured one's
    # masked steps after convergence included
    dflt = {}
    for name, s in (("eager", 1), ("captured", None)):
        res_, _, graphs, _ = cd_run(lambda: fit(None, None, s))
        dflt[name] = dict(out=res_, graphs=graphs,
                          fit_ms=median_ms(lambda: fit(None, None, s), 5))
    (ce, _, le, ne), (cc, _, lc, nc) = (dflt["eager"]["out"],
                                        dflt["captured"]["out"])
    check(ne == nc and torch.equal(ce, cc) and torch.equal(le, lc),
          f"compiled_driver: default-tol fit not bitwise ({ne} / {nc})")
    out["default_tol"] = dict(
        tol=tk.KMeansParams().tol, n_iter=nc,
        steps_launched=dflt["captured"]["graphs"]["steps_launched"],
        fit_ms={n_: d["fit_ms"] for n_, d in dflt.items()})
    return out


def cd_masked_step(x, c0, sync):
    """A masked replay's ms: a loop's chunk of ``sync`` replays that
    converges at its first step (tol inf after a finite inertia) against
    another loop's chunk of ``sync`` active replays (tol -1), each timed
    after the loop's first chunk and its capture (median of 5)."""
    import torch

    from raft_tpu_torch.cluster import kmeans as tk
    from raft_tpu_torch.runtime import compiled_driver as cdrv
    from raft_tpu_torch.util import precision as tprec

    f64 = dict(dtype=torch.float64, device=x.device)
    carry = (c0, torch.ones((), **f64), torch.full((), float("inf"), **f64))
    ms = {}
    with tprec.scope("high"):
        ops, meta = tk.lloyd_prepare(x, MAIN_N)
        for name, tol in (("active", -1.0), ("masked", float("inf"))):
            loop = cdrv.ChunkLoop(
                lambda cr, tol=tol: tk._lloyd_convergence_step(
                    lambda c: tk.lloyd_step_prepared(ops, c, **meta), cr,
                    tol))
            loop(carry, sync)            # the first chunk, step by step
            _, ran, _ = loop(carry, sync)
            check(int(ran) == (sync if tol < 0 else 1),
                  f"compiled_driver: {name} chunk ran {int(ran)} steps")
            ms[name] = median_ms(lambda: loop(carry, sync), 5)
    return dict(chunk_ms=ms, masked_steps=sync - 1,
                ms=(ms["masked"] - ms["active"] / sync) / (sync - 1))


def cd_partial_cpu(res, dev, x, c0, cr):
    """The first CD_CPU_ROWS rows through ``kmeans_partial_fit`` on the
    card (captured) and on the CPU (the plain versions): centroids
    within REL of the largest, labels of the final assignment equal but
    at near-ties. Where the two passes part (a label at a near-tie
    inside the pass moves a centroid), the first step whose labels
    differ must differ at a near-tie only."""
    import torch

    from raft_tpu_torch.cluster import kmeans as tk
    from raft_tpu_torch.util import precision as tprec

    rows = x[:CD_CPU_ROWS]
    with tprec.scope("high"):
        cg, ng = tk.kmeans_partial_fit(res, c0, rows, chunk_rows=cr)
        cc, nc = tk.kmeans_partial_fit(None, c0.cpu(), rows.cpu(),
                                       chunk_rows=cr)
    scale = float(cc.abs().max())
    err = float((cg.cpu() - cc).abs().max())
    out = dict(chunk_rows=cr, centroid_max_abs_err=err, scale=scale)
    if err <= REL * scale and torch.equal(ng.cpu(), nc):
        with tprec.scope("high"):
            lg, _ = tk.kmeans_predict(res, rows, cg)
        lc, _ = tk.kmeans_predict(None, rows.cpu(), cc)
        dscale = ((rows.double() ** 2).sum(1)
                  + (cc.double() ** 2).sum(1).max().to(dev)).float()
        ccd = cc.to(dev)
        bad = labels_agree(lg, lc.to(dev),
                           lambda r: ((rows[r, None, :] - ccd[None]) ** 2
                                      ).sum(-1), dscale, REL,
                           f"partial fit {cr}: labels against the CPU")
        out["labels_differ"] = int(bad.numel())
        return out
    # the passes parted: find the first step whose labels differ
    c_cpu = c0.cpu().clone()
    counts = torch.zeros(MAIN_N)
    for j in range(CD_CPU_ROWS // cr):
        r = rows[j * cr:(j + 1) * cr]
        with tprec.scope("high"):
            _, lab_g = tk._assign(r, c_cpu.to(dev))
            _, lab_c = tk._assign(r.cpu(), c_cpu)
        if not torch.equal(lab_g.cpu(), lab_c):
            dscale = ((r.double() ** 2).sum(1)
                      + (c_cpu.double() ** 2).sum(1).max().to(dev)).float()
            cd_ = c_cpu.to(dev)
            labels_agree(lab_g, lab_c.to(dev),
                         lambda q: ((r[q, None, :] - cd_[None]) ** 2
                                    ).sum(-1), dscale, REL,
                         f"partial fit {cr}: step {j} labels")
            out["parted_at_near_tie_step"] = j
            return out
        with tprec.scope("high"):
            c_cpu, counts = tk.kmeans_partial_fit(
                None, c_cpu, r.cpu(), counts=counts, chunk_rows=cr)
    raise AssertionError(f"partial fit {cr}: centroids off the CPU's by "
                         f"{err} with the same labels at every step")


def cd_partial_part(res, dev, x, c0):
    """(b): ``kmeans_partial_fit`` over config 3's 1M rows at each
    CD_CHUNK_ROWS, eager against captured: bitwise, counts summing to
    the rows, host syncs one a chunk, equal launches; the CPU check; a
    resume from a mid-batch checkpoint; ms and ops a chunk."""
    import math
    import shutil

    import torch

    from raft_tpu_torch.cluster import kmeans as tk
    from raft_tpu_torch.util import precision as tprec

    def pf(batch, cr, s, **kw):
        with tprec.scope("high"):
            return tk.kmeans_partial_fit(res, c0, batch, chunk_rows=cr,
                                         sync_every=s, **kw)

    out = {}
    launches = {}
    for cr in CD_CHUNK_ROWS:
        n_chunks = -(-MAIN_M // cr)
        sync = cd_default_sync(dev, cr)
        pf(x[:CD_CPU_ROWS], cr, None)        # warm-up
        runs = {}
        for name, s in (("eager", 1), ("captured", None), ("captured2",
                                                          None)):
            o, lc, graphs, wall = cd_run(lambda: pf(x, cr, s))
            runs[name] = dict(out=o, launches=lc, graphs=graphs,
                              host_syncs=graphs["host_reads"], wall_s=wall)
        ce, ne = runs["eager"]["out"]
        for name in ("captured", "captured2"):
            cc, nc = runs[name]["out"]
            check(torch.equal(ce, cc) and torch.equal(ne, nc),
                  f"partial fit {cr}: {name} not bitwise the host loop")
        check(float(ne.double().sum()) == MAIN_M,
              f"partial fit {cr}: counts sum to {float(ne.sum())}")
        check(runs["eager"]["launches"] == runs["captured2"]["launches"],
              f"partial fit {cr}: launches {runs['eager']['launches']} vs "
              f"{runs['captured2']['launches']}")
        check(runs["captured2"]["host_syncs"] == math.ceil(n_chunks / sync)
              and runs["eager"]["host_syncs"] == n_chunks,
              f"partial fit {cr}: host syncs {runs['eager']['host_syncs']}"
              f" / {runs['captured2']['host_syncs']}")
        for name, lc in runs["captured2"]["launches"].items():
            launches[name] = launches.get(name, 0) + lc
        # a traced pass of at least 4 chunks (the first launches its
        # steps one by one, the rest replay)
        small = x[:max(CD_CPU_ROWS, 4 * sync * cr)]
        traces = {name: cd_trace(lambda: pf(small, cr, s), 1)
                  for name, s in (("eager", 1), ("captured", None))}
        steps = small.shape[0] // cr
        for tr in traces.values():
            tr["device_ops"] /= steps
            tr["aten_ops"] /= steps
            tr["runtime_calls"] = {k: v / steps
                                   for k, v in tr["runtime_calls"].items()}
        row = dict(n_chunks=n_chunks, sync_every=sync)
        for name, key in (("eager", "eager"), ("captured", "captured2")):
            wall = runs[key]["wall_s"]
            row[name] = dict(pass_s=wall, ms_per_chunk=wall / n_chunks * 1e3,
                             chunks_per_s=n_chunks / wall,
                             host_syncs=runs[key]["host_syncs"],
                             trace_per_chunk=traces[name])
        row["graphs"] = runs["captured2"]["graphs"]
        row["cpu"] = cd_partial_cpu(res, dev, x, c0, cr)
        out[cr] = row
    # a resume from a mid-batch checkpoint, bitwise the uninterrupted run
    cr = CD_CHUNK_ROWS[-1]
    d = os.path.join(OUT_DIR, "kmeans_pf_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    try:
        full = pf(x, cr, None, checkpoint_dir=d, checkpoint_every=1,
                  checkpoint_keep=64)
        path = os.path.join(d, f"kmeans_pf-{CD_RESUME_AT:08d}.ckpt")
        check(os.path.exists(path), f"partial fit: no checkpoint at chunk "
              f"{CD_RESUME_AT}: {sorted(os.listdir(d))}")
        resumed = pf(x, cr, None, resume_from=path)
        check(all(torch.equal(a, b) for a, b in zip(full, resumed)),
              "partial fit: the resumed run is not bitwise the whole run")
        out["resume"] = dict(chunk_rows=cr, from_chunk=CD_RESUME_AT,
                             checkpoints=len(os.listdir(d)), bitwise=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return out, launches


def compiled_driver_phase(res, dev, x):
    """The ``compiled_driver`` line: config 3 through ``kmeans_fit`` and
    ``kmeans_partial_fit`` with captured CUDA-graph chunks against the
    host loop (``sync_every=1``)."""
    import torch

    from raft_tpu_torch import obs
    from raft_tpu_torch.obs import metrics as obs_metrics

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    c0 = x[torch.randperm(MAIN_M, generator=gen, device=dev)[:MAIN_N]]
    sync = cd_default_sync(dev, MAIN_M)
    check(sync > 1, f"compiled_driver: default sync_every {sync} on the "
          "card")
    was = obs.set_enabled(True)          # solver_host_syncs_total
    old = obs_metrics.get_registry()
    try:
        fit = cd_fit_part(res, dev, x, c0, sync)
    finally:
        obs.set_enabled(was)
        obs_metrics.set_registry(old)
    partial, pf_launches = cd_partial_part(res, dev, x, c0)
    launches = {n: fit["launches"].get(n, 0) + pf_launches.get(n, 0)
                for n in fit["launches"]}
    emit("compiled_driver", shape=[MAIN_M, MAIN_K], n_clusters=MAIN_N,
         tier="high", default_sync_every=sync, kmeans_fit=fit,
         kmeans_partial_fit=partial, launches=launches,
         seconds=time.perf_counter() - t0)
    return launches


# ---------------------------------------------------------------------------
# phase 5: pairwise_distance, BASELINE config 1
# ---------------------------------------------------------------------------


def pairwise_phase(res, dev):
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.distance import DistanceType, pairwise_distance
    from raft_tpu_torch.random import RngState, make_blobs

    # BASELINE config 1: make_blobs 5000 x 50, 10 centers
    x, _, _ = make_blobs(res, RngState(SEED + 3), PAIRWISE_M, PAIRWISE_K,
                         n_clusters=10)
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
        # InnerProduct is a bare product, gemm's at the tier (the
        # reference's XLA dot), and launches no kernel
        want_l = {} if name == "InnerProduct" else {"pairwise_tile": 1}
        check(launches == want_l,
              f"pairwise_distance {name}: launches {launches}, want "
              f"{want_l}")
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
    the card's kernels and copies as ``(name, start_us, end_us)``, the
    host's CUDA runtime calls counted by name (the trace's closing
    ``cudaDeviceSynchronize`` among them) and the count of top-level
    torch ops (CPU events named ``aten::*`` under no other aten op)."""
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
    device, runtime, aten = [], {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            device.append((e.name, e.time_range.start, e.time_range.end))
        elif e.name.startswith("cuda"):
            runtime[e.name] = runtime.get(e.name, 0) + 1
        elif e.name.startswith("aten::"):
            parent = e.cpu_parent
            while parent is not None and not parent.name.startswith("aten::"):
                parent = parent.cpu_parent
            aten += parent is None
    check(bool(device), "torch.profiler saw no work on the card")
    return device, runtime, aten


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
    events, *_ = device_trace(fn, reps)
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
    events, *_ = device_trace(lambda: tc.fused_lloyd_prepared(ops, c, m=m),
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


def config4_phase(res, dev):
    """BASELINE config 4 at full size on one card: the R-MAT graph (scale
    20, 10M edges, a/b/c 0.57/0.19/0.19) built on the card by the port's
    generator, one SpMV, one SpMM at k = 16 and the fixed 3-restart
    Lanczos of bench_prims.py:890-893, all through the public entry
    points with the launch counts set to 0 just before; then the gated
    csr_spmv (:func:`gated_spmv_check`), the chunked Lanczos against its
    host loop (:func:`lanczos_chunks`) and the Ritz kernel
    (:func:`ritz_parity`)."""
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
    step_ms = lanczos_ms / n_steps
    gate, gate_err = gated_spmv_check(g, x)
    chunks, chunk_launches = lanczos_chunks(res, dev, g)
    ritz_row = ritz_parity(res, g, dev)
    out = dict(graph=stats, build_s=build_s, spmv_ms=spmv_ms,
               spmm_k16_ms=spmm_ms, lanczos_first_call_s=lanczos_s,
               lanczos_ms=lanczos_ms,
               lanczos_ms_per_restart=lanczos_ms / cfg.max_iterations,
               lanczos_ms_per_step=step_ms, lanczos_steps=n_steps,
               spmv_share_of_step=spmv_ms / step_ms, hub_tail=tail,
               qr_n_by_4_ms=qr_ms, ritz_values=vals.tolist(),
               ritz_orthonormality_err=orth,
               max_abs_err={"csr_spmv": max(err_v, gate_err),
                            "csr_spmm": err_m},
               launches={k: v for k, v in launches.items() if v},
               gated_csr_spmv=gate, lanczos_chunks=chunks,
               chunk_launches={k: v for k, v in chunk_launches.items()
                               if v},
               sym_eig_jacobi={k: ritz_row[k] for k in (
                   "ms", "plain_ms", "library_ms", "bound_ms", "sweeps",
                   "max_abs_err")})
    emit("config4", **out)
    out["ritz_row"] = ritz_row
    for k, v in chunk_launches.items():
        launches[k] = launches.get(k, 0) + v
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
    from raft_tpu_torch.random import RngState, make_blobs

    # BASELINE config 1: make_blobs 5000 x 50, 10 centers
    x, _, _ = make_blobs(res, RngState(SEED + 15), PAIRWISE_M, PAIRWISE_K,
                         n_clusters=10)
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
    radix_threshold, radix_emit, csr_spmv, csr_spmm and mst_min_edge on
    seeded inputs from the
    raft_tpu_torch package under ROOT (this checkout, or another commit's
    package unpacked beside it), each output hashed (SHA-256 of its
    bytes) and timed at the main paths' shapes (topk_insert at the
    WARPSORT_FILTERED shape on random, descending and ascending rows, k =
    64 and 256; unexpanded_tile, the radix kernels, the CSR products and
    mst_min_edge as fingerprint_unexpanded, fingerprint_radix,
    fingerprint_csr and fingerprint_mst say),
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
    fingerprint_csr(gen, dev, digest, hashes, times)
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


def keyed_csr(keys, n_keys, dtype):
    """The CSR [n_keys, m] of linalg.reduce's keyed sums (rows grouped by
    key by a stable sort), built here so that --fingerprint can run it on
    a package without linalg.reduce."""
    import torch

    srt, order = torch.sort(keys.long(), stable=True)
    indptr = torch.searchsorted(srt, torch.arange(n_keys + 1,
                                                  device=keys.device))
    return indptr, order.to(torch.int32), torch.ones(
        keys.numel(), dtype=dtype, device=keys.device)


def fingerprint_csr(gen, dev, digest, hashes, times):
    """csr_spmv and csr_spmm in --fingerprint: y hashed on the parity
    phase's hub graph (a 100,000-entry hub row, NaN pads, f32 and f64,
    int32 and int64 indptr), C hashed there at k = 16, 33, 200 and 1024;
    both hashed and timed on BASELINE config 4's graph (built as
    config4_phase builds it, the SpMM at SPMM_K), and csr_spmm hashed
    and timed at config 2's keyed shapes (C2_KEYS row keys over a
    C2_M x C2_N B, C2_COL_KEYS column keys over its transpose)."""
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
        for k in (16, 33, 200, 1024):
            b = torch.randn(n, k, generator=gen, device=dev, dtype=dtype)
            hashes[f"csr_spmm hub k={k} {dtype}"] = digest([tg._spmm(
                indptr, indices, data, b, n)])
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
    b = torch.randn(g.n_rows, SPMM_K, generator=gen, device=dev)
    mm = (g.indptr, g.indices, g.data, b, g.n_rows)
    hashes["csr_spmm config 4"] = digest([tg._spmm(*mm)])
    times["csr_spmm config 4"] = cuda_ms(lambda: tg._spmm(*mm), 20)
    del g, ops, mm, b
    a = torch.randn(C2_M, C2_N, generator=gen, device=dev)
    for what, nk, bb in (("rows", C2_KEYS, a),
                         ("cols", C2_COL_KEYS, a.T.contiguous())):
        keys = torch.randint(0, nk, (bb.shape[0],), generator=gen,
                             device=dev)
        mm = keyed_csr(keys, nk, torch.float32) + (bb, nk)
        hashes[f"csr_spmm config 2 {what}"] = digest([tg._spmm(*mm)])
        times[f"csr_spmm config 2 {what}"] = cuda_ms(
            lambda mm=mm: tg._spmm(*mm), 20)
    del a, bb, mm
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


# ---------------------------------------------------------------------------
# phase 13: the comms layer and the MNMG Lloyd step (NCCL, world size 1)
# ---------------------------------------------------------------------------

# BASELINE config 5: 10M x 256 f32, k = 4096
C5_M, C5_D, C5_K, C5_ITERS = 10_000_000, 256, 4096, 3
C5_SAMPLE = 65536          # config-5 rows held against the plain version
C5_SUM_CHUNK = 1 << 20     # rows a chunk of the f64 sums of the halves
NAN_METRICS = ("l2", "euclidean", "cosine", "inner", "l1", "linf",
               "canberra")
NAN_KS = (3, 64, 257, 300)
NAN_WIDE = 32768                   # the kNN chunk's width (4096 queries)


def comms_self_tests(res):
    """Every perform_test_comms_* and perform_test_comm_split(1) on the
    handle's NCCL communicator, on CUDA tensors: each must return True.
    Returns each one's wall milliseconds."""
    import torch

    from raft_tpu_torch.comms import test_suite as ts

    times = {}
    names = sorted(n for n in dir(ts) if n.startswith("perform_test_comms_"))
    for name in names + ["perform_test_comm_split"]:
        fn = getattr(ts, name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = fn(res, n_colors=1) if name == "perform_test_comm_split" \
            else fn(res)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        check(ok is True, f"comms self-test {name} returned {ok}")
    return times


def config5_against_plain(x, c0, step):
    """fused_lloyd at config 5's width (d = 256, k = 4096) against its
    plain version, apart from lloyd_step, which launches the same kernel.
    The first C5_SAMPLE rows through the kernel and the plain version, as
    in the parity phase (labels equal but at near-ties, distances and
    sums within REL, counts exact); the step's labels on those rows
    against the plain labels; and the step's sums and counts over all
    C5_M rows against the kernel's labels: counts their bincount, sums
    within REL x each cluster's |x| mass of the bf16 halves summed apart
    in f64, as the kernel sums them apart in f32. ``step`` is the first
    mnmg_lloyd_step's (centroids, inertia, labels) from ``c0``. Returns
    the max abs errors and the near-tie label counts."""
    import torch

    from raft_tpu_torch.cluster import kmeans as tk
    from raft_tpu_torch.linalg import contractions as tc

    s = C5_SAMPLE
    xs = tc._side(x[:s], "high")
    ys = tc._side(c0, "high")
    want = tc._lloyd_plain("high", xs, ys, s, C5_K, C5_D)
    dscale = ((x[:s].double() ** 2).sum(1)
              + (c0.double() ** 2).sum(1).max()).float()
    out, sample_err = lloyd_parity("high", xs, ys, want, s, C5_K, C5_D,
                                   dscale, f"config 5 fused_lloyd on {s} rows")
    step_bad = labels_agree(step[2][:s], want[3],
                            plain_rows("high", "l2", xs, ys, C5_K, C5_D),
                            dscale, REL, "config 5 step labels on the sample")
    del xs, want
    sums, counts, _, labels = tk.fused_lloyd_pallas(x, c0)
    check(torch.equal(labels, step[2])
          and torch.equal(tk._finish_update(sums, counts, c0), step[0]),
          "config 5: fused_lloyd's labels or centroids are not the step's")
    err, err_over_mass = lloyd_sums_f64(x, labels, sums, counts, C5_K,
                                        "config 5")
    return {"sample_rows": s, "sample_max_abs_err": sample_err,
            "sample_near_tie_labels": out[-1],
            "step_near_tie_labels_on_sample": int(step_bad.numel()),
            "sums_max_abs_err": err,
            "sums_max_err_over_mass": err_over_mass,
            "tolerance": f"sample as the parity phase; sums within {REL} x "
                         "the cluster's |x| mass of an f64 sum of the "
                         "halves under the kernel's labels; counts exact"}


def lloyd_sums_f64(x, labels, sums, counts, n, what):
    """A 'high' Lloyd pass's counts and sums over many rows, against its
    own labels: counts their bincount; sums within REL x each cluster's
    |x| mass of an f64 sum of the bf16 halves (the kernel sums the halves
    apart in f32; an f32 reference sum of 10^5 or more rows a cluster
    would itself be off by more). Returns the max abs error and the max
    of error over mass."""
    import torch

    from raft_tpu_torch.linalg import contractions as tc

    lab = labels.long()
    check(torch.equal(counts, torch.bincount(lab, minlength=n).float()),
          f"{what}: counts != bincount(labels)")
    own = torch.zeros(n, x.shape[1], dtype=torch.float64, device=x.device)
    mass = torch.zeros_like(own)
    for r in range(0, x.shape[0], C5_SUM_CHUNK):
        li = lab[r:r + C5_SUM_CHUNK]
        for half in tc._split_hi_lo(x[r:r + C5_SUM_CHUNK]):
            half = half.double()
            own.index_add_(0, li, half)
            mass.index_add_(0, li, half.abs())
    err = (sums.double() - own).abs()
    check(bool((err <= REL * mass + 1e-6).all()),
          f"{what}: sums off the kernel's own labels by {float(err.max())}")
    live = mass > 0
    return float(err.max()), float((err / mass)[live].max())


def config5_data(dev):
    """Config 5's rows (10M x 256 blobs) and starting centroids (k = 4096
    of the rows), from the seed."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    x = blobs(gen, dev, C5_M, C5_D, C5_K)
    c0 = x[torch.randperm(C5_M, generator=gen, device=dev)[:C5_K]].clone()
    return x, c0


def config5_step(res, mesh, dev, x, c0):
    """Config 5 at full width: 3 Lloyd iterations of mnmg_lloyd_step over
    the one-rank data axis and 3 of lloyd_step from the same centroids,
    bitwise equal; their times, the all-reduces' share and the bound."""
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.cluster import kmeans as tk
    from raft_tpu_torch.comms import device as cdev
    from raft_tpu_torch.util import precision as tprec

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with tprec.scope("high"), cdev.mesh_scope(mesh):
        got, want = [], []
        c = c0
        for _ in range(C5_ITERS):
            c, inertia, labels = tk.mnmg_lloyd_step(x, c, C5_K)
            got.append((c, inertia, labels))
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        c = c0
        for _ in range(C5_ITERS):
            c, inertia, labels = tk.lloyd_step(x, c, C5_K)
            want.append((c, inertia, labels))
        check(launches["fused_lloyd"] >= C5_ITERS,
              f"config 5 step launched fused_lloyd "
              f"{launches['fused_lloyd']} times")
        for i, (g, w) in enumerate(zip(got, want)):
            for a, b, what in zip(g, w, ("centroids", "inertia", "labels")):
                check(torch.equal(a, b), f"config 5 iteration {i}: "
                      f"mnmg_lloyd_step {what} differ from lloyd_step's")
        check(bool(torch.isfinite(got[-1][0]).all())
              and bool(torch.isfinite(got[-1][1])),
              "config 5: centroids or inertia not finite")
        plain = config5_against_plain(x, c0, got[0])
        mnmg_ms = cuda_ms(lambda: tk.mnmg_lloyd_step(x, c0, C5_K), 3)
        lloyd_ms = cuda_ms(lambda: tk.lloyd_step(x, c0, C5_K), 3)
        sums = torch.zeros(C5_K, C5_D, device=dev)
        counts = torch.zeros(C5_K, device=dev)
        inertia0 = torch.zeros((), device=dev)

        def allreduces():
            for t in (sums, counts, inertia0):
                cdev.allreduce(t, cdev.Op.SUM, axis_name="data")

        ar_ms = cuda_ms(allreduces, 10)
    out_bytes = 4 * (C5_K * C5_D + C5_K + 2 * C5_M)   # sums, counts, labels
    b_ms, b_by = bound("high", C5_M, C5_K, C5_D, out_bytes)
    del got, want
    torch.cuda.empty_cache()
    return {"shape": [C5_M, C5_D], "n_clusters": C5_K, "tier": "high",
            "iterations": C5_ITERS, "bitwise_equal_to_lloyd_step": True,
            "mnmg_ms_per_iter": mnmg_ms, "lloyd_step_ms_per_iter": lloyd_ms,
            "allreduce_ms": ar_ms, "allreduce_share": ar_ms / mnmg_ms,
            "allreduce_bytes": 4 * (C5_K * C5_D + C5_K + 1),
            "bound_ms": b_ms, "bound_by": b_by, "against_plain": plain,
            "launches": launches}


def model_axis_step(mesh2, dev):
    """The model-axis branch at the main path's shape on a (1, 1) mesh:
    labels equal lloyd_step's, centroids to REL of the data."""
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.cluster import kmeans as tk
    from raft_tpu_torch.comms import device as cdev
    from raft_tpu_torch.util import precision as tprec

    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    x = blobs(gen, dev, MAIN_M, MAIN_K, MAIN_N)
    c0 = x[torch.randperm(MAIN_M, generator=gen, device=dev)[:MAIN_N]].clone()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with tprec.scope("high"), cdev.mesh_scope(mesh2):
        c, inertia, labels = tk.mnmg_lloyd_step(x, c0, MAIN_N,
                                                model_axis="model")
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        wc, winertia, wlabels = tk.lloyd_step(x, c0, MAIN_N)
        step_ms = cuda_ms(lambda: tk.mnmg_lloyd_step(
            x, c0, MAIN_N, model_axis="model"), 3)
    for name in ("fused_argmin", "csr_spmm"):
        check(launches[name] > 0, f"model-axis step never launched {name}")
    check(torch.equal(labels, wlabels),
          "model-axis labels differ from lloyd_step's")
    mag = float(x.abs().max())
    err = float((c - wc).abs().max())
    check(err <= REL * mag, f"model-axis centroids differ by {err}")
    ierr = abs(float(inertia) - float(winertia)) / float(winertia)
    check(ierr <= REL, f"model-axis inertia differs by {ierr} relative")
    return {"shape": [MAIN_M, MAIN_K], "n_clusters": MAIN_N,
            "labels_equal": True, "centroid_max_abs_err": err,
            "inertia_rel_err": ierr, "ms_per_iter": step_ms,
            "launches": launches}


def nan_probe_card(dev):
    """C1 on the card: a NaN database row through every route, on CUDA
    tensors against the same call on CPU tensors (the plain versions):
    indices equal, values equal or both NaN. The probe (300 rows) through
    knn (fused and scan routes) and through the scan and radix routes'
    own functions; the same rows tiled to the kNN chunk's width through
    knn (the radix route at k > 256 and for l1, linf, canberra)."""
    import numpy as np
    import torch

    from raft_tpu_torch.neighbors import brute_force as tbf
    from raft_tpu_torch.util import precision as tprec

    rng = np.random.default_rng(1)
    db = np.round(rng.standard_normal((300, 8))).astype(np.float32)
    q = db[:17].copy()
    db[7, 2] = np.nan
    wide = np.tile(db, (NAN_WIDE // 300 + 1, 1))[:NAN_WIDE]
    routes = {}
    cpu = torch.device("cpu")

    def both(fn, what):
        gv, gi = fn(dev)
        wv, wi = fn(cpu)
        check(torch.equal(gi.cpu(), wi) and equal_with_nan(gv.cpu(), wv),
              f"NaN probe {what}: the card differs from the CPU")

    with tprec.scope("high"):
        for metric in NAN_METRICS:
            km = tbf._resolve_metric(metric)
            for k in NAN_KS:
                for name, base in (("probe", db), ("chunk_width", wide)):
                    path = tbf.knn_plan(17, base.shape[0], k, metric)[0]
                    routes.setdefault(f"{name}/{path}", 0)
                    routes[f"{name}/{path}"] += 1
                    both(lambda d, b=base, m=metric, kk=k: tbf.knn(
                        None, torch.as_tensor(b, device=d),
                        torch.as_tensor(q, device=d), kk, metric=m),
                        f"knn {name} {metric} k={k} ({path})")
                tile = tbf._clamp_tile(128, k, 300)
                both(lambda d, m=km, kk=k, t=tile: tbf._knn_scan(
                    torch.as_tensor(q, device=d),
                    torch.as_tensor(db, device=d), kk, t, m),
                    f"scan {metric} k={k}")
                both(lambda d, m=km, kk=k: tbf._knn_chunked(
                    torch.as_tensor(q, device=d),
                    torch.as_tensor(db, device=d), kk, 384, m),
                    f"radix {metric} k={k}")
    check(any(r.endswith("/radix") for r in routes)
          and any(r.endswith("/fused") for r in routes),
          f"the NaN probe missed a route: {routes}")
    return routes


# ---------------------------------------------------------------------------
# phase 14: the MNMG solvers through their entry points (NCCL, world size 1)
# ---------------------------------------------------------------------------

FIT_ITERS, FIT_RESUME_AT = 4, 2     # config 5 through kmeans_fit_mnmg
MNMG_SCAN_Q = 256                   # knn_mnmg's scan metrics: queries
MNMG_SCAN_TILE = 8192               # the scan's database tile
SENTINEL_PAD = 1000                 # pad rows of the l2 sentinel check
EIG_TOL = 1e-4       # eigenvalues: config4_phase's orthonormality bar


FIT_CHUNK = 2        # sync_every of config 5's chunked fit: a capture


def config5_fit_chunks(res, mesh, x, c0, params, host, d):
    """(a') config 5 through ``kmeans_fit_mnmg`` at sync_every FIT_CHUNK
    (FIT_ITERS iterations: a first chunk launched step by step, then a
    captured graph of the masked MNMG step, its all-reduce inside,
    replayed): centroids, inertia, labels and n_iter bitwise the host
    loop's ``host``; the chunk-boundary checkpoints (every FIT_CHUNK
    iterations) hold the host loop's centroids at the same iterations
    (the files in ``d``); ms an iteration."""
    import shutil

    import torch

    from raft_tpu_torch.cluster import kmeans as tk
    from raft_tpu_torch.core.checkpoint import restore_checkpoint

    dc = os.path.join(OUT_DIR, "mnmg_fit_chunked_ckpt")
    shutil.rmtree(dc, ignore_errors=True)

    def fit(ckpt=True):
        kw = dict(checkpoint_every=1, checkpoint_dir=dc,
                  checkpoint_keep=FIT_ITERS) if ckpt else {}
        return tk.kmeans_fit_mnmg(res, params, x, c0, mesh=mesh,
                                  sync_every=FIT_CHUNK, **kw)

    got, launches, gs, wall = cd_run(fit)
    for a, b, what in zip(got, host, ("centroids", "inertia", "labels",
                                      "n_iter")):
        same = torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        check(same, f"config 5 chunked fit: {what} differ from the host "
              "loop's")
    names = sorted(os.listdir(dc))
    want = [f"kmeans-{i:08d}.ckpt"
            for i in range(FIT_CHUNK, FIT_ITERS + 1, FIT_CHUNK)]
    check(names == want, f"config 5 chunked fit: checkpoints {names}")
    for name in names:
        check(torch.equal(
            torch.as_tensor(restore_checkpoint(os.path.join(
                dc, name))["centroids"]),
            torch.as_tensor(restore_checkpoint(os.path.join(
                d, name))["centroids"])),
            f"config 5 chunked fit: {name}'s centroids differ from the "
            "host loop's")
    check(gs["captures"] == 1 and gs["host_reads"] == -(-FIT_ITERS
                                                        // FIT_CHUNK),
          f"config 5 chunked fit: graph counts {gs}")
    shutil.rmtree(dc)
    ms = cuda_ms(lambda: fit(False), 1) / (FIT_ITERS + 1)
    return {"sync_every": FIT_CHUNK, "bitwise_host_loop": True,
            "checkpoints": names, "checkpoint_centroids_equal": True,
            "fit_ms_per_iter": ms, "first_call_s": wall,
            "captures": gs["captures"], "replays": gs["replays"],
            "host_reads": gs["host_reads"]}, launches


def config5_fit(res, mesh, dev, x, c0):
    """(a) BASELINE config 5 through ``kmeans_fit_mnmg`` at full width
    and its default ``sync_every`` (the host loop): 4 iterations, tol 0,
    a checkpoint every iteration under chiprun_out/. Its centroids, inertia and labels bitwise equal to 4
    mnmg_lloyd_steps plus the final re-assign; its n_iter kmeans_fit's
    (and its centroids within REL of the data of kmeans_fit's); resumed
    from the iteration-2 checkpoint, bitwise the same. Times: the fit's
    ms an iteration (the re-assign counted as one) beside the step's,
    and one checkpoint save of the 4 MB centroids."""
    import shutil
    import warnings

    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.cluster import kmeans as tk
    from raft_tpu_torch.comms import device as cdev
    from raft_tpu_torch.core import checkpoint as ckpt
    from raft_tpu_torch.random import RngState
    from raft_tpu_torch.util import precision as tprec

    d = os.path.join(OUT_DIR, "mnmg_fit_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    params = tk.KMeansParams(n_clusters=C5_K, max_iter=FIT_ITERS, tol=0.0)
    with warnings.catch_warnings(), tprec.scope("high"):
        warnings.simplefilter("ignore", RuntimeWarning)   # tol 0: by design
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        c, inertia, labels, n_iter = tk.kmeans_fit_mnmg(
            res, params, x, c0, mesh=mesh, checkpoint_every=1,
            checkpoint_dir=d, checkpoint_keep=FIT_ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        check(launches["fused_lloyd"] == FIT_ITERS + 1,
              f"config 5 fit: fused_lloyd launched "
              f"{launches['fused_lloyd']} times, want {FIT_ITERS + 1}")
        # checks, after the counted run
        with cdev.mesh_scope(mesh):
            cc = c0
            for _ in range(FIT_ITERS):
                cc, _, _ = tk.mnmg_lloyd_step(x, cc, C5_K)
            _, w_inertia, w_labels = tk.mnmg_lloyd_step(x, cc, C5_K)
        for a, b, what in ((c, cc, "centroids"), (inertia, w_inertia,
                                                  "inertia"),
                           (labels, w_labels, "labels")):
            check(torch.equal(a, b), f"config 5 fit: {what} differ from "
                  f"{FIT_ITERS} mnmg_lloyd_steps and the re-assign")
        check(bool(torch.isfinite(c).all()) and tuple(labels.shape)
              == (C5_M,), "config 5 fit: output")
        fc, _, _, f_iter = tk.kmeans_fit(res, params, x, c0)
        check(f_iter == n_iter == FIT_ITERS,
              f"config 5 fit: n_iter {n_iter}, kmeans_fit's {f_iter}")
        fit_err = float((fc - c).abs().max())
        check(fit_err <= REL * float(x.abs().max()),
              f"config 5 fit: centroids off kmeans_fit's by {fit_err}")
        names = sorted(os.listdir(d))
        check(names == [f"kmeans-{i:08d}.ckpt"
                        for i in range(1, FIT_ITERS + 1)],
              f"config 5 fit: checkpoints {names}")
        rc, ri, rl, rn = tk.kmeans_fit_mnmg(
            res, params, x, mesh=mesh,
            resume_from=os.path.join(d, f"kmeans-{FIT_RESUME_AT:08d}.ckpt"))
        check(rn == n_iter and torch.equal(rc, c) and torch.equal(ri, inertia)
              and torch.equal(rl, labels),
              "config 5 fit: the resumed fit differs from the whole one")
        fit_ms = cuda_ms(lambda: tk.kmeans_fit_mnmg(
            res, params, x, c0, mesh=mesh), 1) / (
                FIT_ITERS + 1)
        chunked, chunk_launches = config5_fit_chunks(
            res, mesh, x, c0, params, (c, inertia, labels, n_iter), d)
        with cdev.mesh_scope(mesh):
            step_ms = cuda_ms(lambda: tk.mnmg_lloyd_step(x, c0, C5_K), 3)
    mgr = ckpt.CheckpointManager(d, prefix="timed", keep=1)
    saves = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(i, {"centroids": c, "prev_inertia": float(inertia),
                     "n_iter": i, "rng": RngState(seed=0)})
        saves.append((time.perf_counter() - t0) * 1e3)
    nbytes = os.path.getsize(mgr.path_for(4))
    shutil.rmtree(d)
    return {"shape": [C5_M, C5_D], "n_clusters": C5_K, "tier": "high",
            "max_iter": FIT_ITERS, "n_iter": n_iter, "wall_s": wall,
            "bitwise_equal_to_step_loop": True,
            "resumed_from": FIT_RESUME_AT, "resume_bitwise": True,
            "kmeans_fit_n_iter": f_iter,
            "kmeans_fit_centroids_bitwise": bool(torch.equal(fc, c)),
            "kmeans_fit_centroid_max_abs_err": fit_err,
            "fit_ms_per_iter": fit_ms, "step_ms_per_iter": step_ms,
            "checkpoint_save_ms": sorted(saves)[2],
            "checkpoint_save_ms_all": saves, "checkpoint_bytes": nbytes,
            "launches": {k: v for k, v in launches.items() if v},
            "chunked": chunked}, \
        {k: launches.get(k, 0) + chunk_launches.get(k, 0)
         for k in set(launches) | set(chunk_launches)}


def l2_rows(q, db):
    """``dist_rows`` of exact squared L2 distances (f64)."""
    d64 = db.double()
    n2 = (d64 ** 2).sum(1)
    return lambda rows: ((q[rows].double() ** 2).sum(1)[:, None]
                         - 2.0 * q[rows].double() @ d64.T + n2[None, :])


def knn_mnmg_phase(res, mesh, dev):
    """(b) knn_mnmg at the kNN path's width (db 2^20 x 128, 'high'): l2
    at k = 64 on 4096 queries (the fused kernel), inner and l1 at k = 64
    on 256 queries (the scan, one pairwise or unexpanded tile a 8192-row
    block), each against knn on the same inputs: indices equal but at
    near-ties, distances within the tie band. Then the l2 pad sentinel at
    'high': a shard padded with 1e15 rows through the fused kernel never
    returns a pad row and matches the unpadded shard. Each kernel held
    against its plain version at the scan's tile."""
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.linalg import contractions as tc
    from raft_tpu_torch.neighbors import brute_force as tbf
    from raft_tpu_torch.neighbors import fused_topk
    from raft_tpu_torch.util import precision as tprec

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    db = torch.randn(KNN_N, KNN_D, generator=gen, device=dev)
    q = torch.randn(KNN_Q, KNN_D, generator=gen, device=dev)
    db64 = db.double()
    tiles = -(-KNN_N // MNMG_SCAN_TILE)
    total, calls, errs = {}, {}, {}
    for metric, nq, want_l in (
            ("l2", KNN_Q, {"fused_topk": 1}),
            ("inner", MNMG_SCAN_Q, {"pairwise_tile": tiles}),
            ("l1", MNMG_SCAN_Q, {"unexpanded_tile": tiles})):
        qq = q[:nq].contiguous()
        with tprec.scope("high"):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            got = tbf.knn_mnmg(res, db, qq, UNEXP_K, metric=metric,
                               mesh=mesh)
            torch.cuda.synchronize()
            counts = {n_: c for n_, c in kernels.launch_counts().items()
                      if c}
            want = tbf.knn(res, db, qq, UNEXP_K, metric=metric)
            ms = cuda_ms(lambda: tbf.knn_mnmg(res, db, qq, UNEXP_K,
                                              metric=metric, mesh=mesh), 2)
            knn_ms = cuda_ms(lambda: tbf.knn(res, db, qq, UNEXP_K,
                                             metric=metric), 2)
        check(counts == want_l, f"knn_mnmg {metric}: launches {counts}, "
              f"want {want_l}")
        for n_, c in counts.items():
            total[n_] = total.get(n_, 0) + c
        if metric == "l2":
            rows, rel = l2_rows(qq, db), REL
            scale = ((qq.double() ** 2).sum(1)
                     + (db64 ** 2).sum(1).max()).float()
        elif metric == "inner":
            rows = lambda r: -(qq[r].double() @ db64.T)     # noqa: E731
            scale = (qq.double().norm(dim=1)
                     * db64.norm(dim=1).max()).float()
            rel = REL
        else:
            rows = lambda r: torch.cdist(qq[r].double(), db64,  # noqa: E731
                                         p=1.0)
            scale = (qq.abs().sum(1) + db.abs().sum(1).max()).float()
            rel = unexp_rel(KNN_D)
        bad, err = topk_lists_agree(got, want, rows, scale, rel,
                                    f"knn_mnmg {metric} against knn")
        calls[metric] = dict(queries=nq, k=UNEXP_K, ms=ms, knn_ms=knn_ms,
                             launches=counts, differing_indices=bad,
                             max_abs_err=err,
                             bitwise_equal_to_knn=bool(
                                 torch.equal(got[0], want[0])
                                 and torch.equal(got[1], want[1])))
    # kernels against their plain versions at the scan's tile
    qs = q[:MNMG_SCAN_Q].contiguous()
    blk = db[:MNMG_SCAN_TILE].contiguous()
    with tprec.scope("high"):
        xs, ys = tc._side(qs, "high"), tc._side(blk, "high")
        tile = tc._pairwise_tile("high", "inner", xs, ys, MNMG_SCAN_Q,
                                 MNMG_SCAN_TILE, KNN_D)
        plain = tc._pairwise_plain("high", "inner", xs, ys, MNMG_SCAN_Q,
                                   MNMG_SCAN_TILE, KNN_D)
    band = REL * (qs.norm(dim=1)[:, None] * blk.norm(dim=1)[None, :])
    e = (tile - plain).abs()
    check(bool((e <= band + 1e-6).all()),
          f"pairwise_tile inner at the scan tile: off by {float(e.max())}")
    errs["pairwise_tile"] = float(e.max())
    got_l1 = tc.pairwise_unexpanded_pallas(qs, blk, "l1")
    want_l1 = tc.unexpanded_ref(qs, blk, "l1")
    e = (got_l1 - want_l1).abs()
    check(bool((e <= unexp_rel(KNN_D) * want_l1.abs() + 1e-6).all()),
          f"unexpanded_tile l1 at the scan tile: off by {float(e.max())}")
    errs["unexpanded_tile"] = float(e.max())
    # the l2 pad sentinel at 'high': a short shard's pad rows never rank
    short = db[:KNN_N - SENTINEL_PAD]
    padded = torch.cat([short, torch.full((SENTINEL_PAD, KNN_D),
                                          tbf._PAD_SENTINEL, device=dev)])
    with tprec.scope("high"):
        pv, pi = fused_topk.knn_fused(q, padded.contiguous(), UNEXP_K, "l2")
        sv, si = fused_topk.knn_fused(q, short.contiguous(), UNEXP_K, "l2")
    check(int(pi.max()) < KNN_N - SENTINEL_PAD and bool(
        torch.isfinite(pv).all()), "the 1e15 pad rows ranked in")
    sbad, serr = topk_lists_agree((pv, pi), (sv, si), l2_rows(q, short),
                                  ((q.double() ** 2).sum(1)
                                   + (short.double() ** 2).sum(1).max()
                                   ).float(), REL, "padded shard")
    errs["fused_topk"] = serr
    del db, q, db64, padded, short
    torch.cuda.empty_cache()
    return {"db": [KNN_N, KNN_D], "tier": "high", "calls": calls,
            "scan_tile": [MNMG_SCAN_Q, MNMG_SCAN_TILE, KNN_D],
            "sentinel": {"pad_rows": SENTINEL_PAD, "value": 1e15,
                         "pad_row_returned": False,
                         "differing_indices": sbad, "max_abs_err": serr},
            "max_abs_err": errs,
            "tolerance": f"indices equal but at near-ties, values within "
                         f"{REL} x (|q|^2 + max|x|^2) (l2), {REL} x "
                         f"|q| max|x| (inner), {unexp_rel(KNN_D):.3g} x "
                         "(|q|_1 + max|x|_1) (l1)"}, total, errs


EIG_CHUNK_ITERS, EIG_CHUNK = 6, 2   # eigsh_mnmg's chunked solve


def eigsh_mnmg_chunks(lap, mesh):
    """eigsh_mnmg on config 4's normalized Laplacian (k = 4, ncv 20,
    EIG_CHUNK_ITERS outer iterations, tol 0) at sync_every 1 and
    EIG_CHUNK (its later chunks replay a captured graph, the band's
    all-gather and the all-reduces inside), with a checkpoint at every
    boundary: eigenpairs and n_iter bit for bit, every chunked checkpoint
    equal entry for entry to the host loop's of the same iteration;
    ms a restart each."""
    import shutil
    import warnings

    import numpy as np
    import torch

    from raft_tpu_torch.core.checkpoint import restore_checkpoint
    from raft_tpu_torch.sparse.solver import eigsh_mnmg

    dirs = {s: os.path.join(OUT_DIR, f"eigsh_ckpt_{s}")
            for s in (1, EIG_CHUNK)}
    runs, ref, launches_all = {}, None, {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # tol 0: by design
        for sync, d in dirs.items():
            shutil.rmtree(d, ignore_errors=True)

            def solve(sync=sync, ckpt=True, d=d):
                kw = dict(checkpoint_every=1, checkpoint_dir=d,
                          checkpoint_keep=EIG_CHUNK_ITERS) if ckpt else {}
                return eigsh_mnmg(lap, k=4, mesh=mesh, ncv=20,
                                  maxiter=EIG_CHUNK_ITERS, tol=0.0,
                                  return_report=True, sync_every=sync,
                                  **kw)

            (w, v, rep), launches, gs, wall = cd_run(solve)
            if ref is None:
                ref = (w, v, rep.n_iter)
            check(torch.equal(w, ref[0]) and torch.equal(v, ref[1])
                  and rep.n_iter == ref[2] == EIG_CHUNK_ITERS,
                  f"eigsh_mnmg sync_every={sync} differs from the host loop")
            ms = cuda_ms(lambda: solve(ckpt=False), 1)
            runs[str(sync)] = {"ms_per_solve": ms,
                               "ms_per_restart": ms / EIG_CHUNK_ITERS,
                               "first_call_s": wall,
                               "host_reads": gs["host_reads"],
                               "captures": gs["captures"],
                               "replays": gs["replays"]}
            for k_, n_ in launches.items():
                launches_all[k_] = launches_all.get(k_, 0) + n_
    host, chunk = (sorted(os.listdir(dirs[s])) for s in (1, EIG_CHUNK))
    check(set(chunk) <= set(host) and len(chunk) >= 3,
          f"eigsh_mnmg chunked checkpoints {chunk} against {host}")
    for name in chunk:
        a, b = (restore_checkpoint(os.path.join(dirs[s], name))
                for s in (EIG_CHUNK, 1))
        check(all(np.array_equal(np.asarray(a[k_]), np.asarray(b[k_]))
                  for k_ in ("basis", "t", "v", "beta_last", "it")),
              f"eigsh_mnmg checkpoint {name}: chunked differs from host")
    check(runs[str(EIG_CHUNK)]["captures"] == 1,
          "eigsh_mnmg chunked: no capture")
    for d in dirs.values():
        shutil.rmtree(d)
    return {"restarts": EIG_CHUNK_ITERS, "sync_every": EIG_CHUNK,
            "bitwise_host_loop": True, "checkpoints": chunk,
            "checkpoints_equal_host_loop": True, "runs": runs}, launches_all


def eigsh_mnmg_phase(res, mesh, dev, g):
    """(c) eigsh_mnmg on config 4's normalized Laplacian (R-MAT scale
    20), k = 4, ncv = 20, 3 restarts, tol 0, as config4_phase runs its
    Lanczos: eigenvalues within EIG_TOL of the single-device solver's,
    Ritz vectors orthonormal to EIG_TOL, csr_spmv launched once a
    Lanczos step and held against its plain version on the band."""
    import warnings

    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.sparse import linalg
    from raft_tpu_torch.sparse.solver import (LanczosConfig, eigsh_mnmg,
                                              lanczos_compute_eigenpairs)

    lap = linalg.laplacian_normalized(g)
    cfg = LanczosConfig(n_components=4, ncv=20, max_iterations=3,
                        tolerance=0.0)
    n_steps = cfg.ncv + (cfg.max_iterations - 1) * (cfg.ncv
                                                    - cfg.n_components)

    def mnmg():
        return eigsh_mnmg(lap, k=4, mesh=mesh, ncv=20, maxiter=3, tol=0.0,
                          return_report=True)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # tol 0: by design
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        w, v, rep = mnmg()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        check(launches["csr_spmv"] == n_steps,
              f"eigsh_mnmg: csr_spmv launches {launches['csr_spmv']}, "
              f"want {n_steps}")
        ws, _ = lanczos_compute_eigenpairs(res, lap, cfg)
        mnmg_ms = cuda_ms(mnmg, 1)
        eigsh_ms = cuda_ms(lambda: lanczos_compute_eigenpairs(res, lap, cfg),
                           1)
    err = float((w - ws).abs().max())
    check(err <= EIG_TOL, f"eigsh_mnmg eigenvalues off eigsh's by {err}")
    check(rep.n_iter == cfg.max_iterations and tuple(v.shape)
          == (g.n_rows, 4) and bool(torch.isfinite(v).all()),
          "eigsh_mnmg: output")
    gram = v.double().T @ v.double()
    orth = float((gram - torch.eye(4, device=dev,
                                   dtype=torch.float64)).abs().max())
    check(orth <= EIG_TOL, f"eigsh_mnmg Ritz vectors not orthonormal: "
          f"{orth}")
    plan = linalg._cached_plan(lap)
    err_v = sparse_pair(plan.indptr, plan.indices, plan.data,
                        v[:, :1].contiguous(), g.n_rows,
                        "eigsh_mnmg csr_spmv on the normalized Laplacian")
    # the restart's orthonormalization at its shape [n, k]: CholeskyQR2
    # across the ranks against the one-device Householder QR
    from raft_tpu_torch.comms import device as cdev
    from raft_tpu_torch.sparse.solver import lanczos as tl

    ax = cdev._axis_of_mesh(mesh, "data")
    cholqr_ms = cuda_ms(lambda: tl._cholqr2(v, lambda t: cdev.allreduce(
        t, cdev.Op.SUM, axis_name=ax)), 10)
    qr_ms = cuda_ms(lambda: torch.linalg.qr(v), 10)
    chunked, chunk_launches = eigsh_mnmg_chunks(lap, mesh)
    for k_, n_ in chunk_launches.items():
        launches[k_] = launches.get(k_, 0) + n_
    del lap, plan
    torch.cuda.empty_cache()
    return {"graph": "config 4 R-MAT scale 20, normalized Laplacian",
            "k": 4, "ncv": 20, "restarts": 3, "steps": n_steps,
            "wall_s": wall, "eigenvalues": w.tolist(),
            "eigsh_eigenvalues": ws.tolist(), "max_abs_err": err,
            "ritz_orthonormality_err": orth,
            "ms_per_step": mnmg_ms / n_steps,
            "eigsh_ms_per_step": eigsh_ms / n_steps,
            "csr_spmv_max_abs_err": err_v,
            "restart_cholqr2_ms": cholqr_ms,
            "restart_householder_qr_ms": qr_ms,
            "tolerance": f"eigenvalues within {EIG_TOL} of eigsh's",
            "launches": {k: v for k, v in launches.items() if v},
            "chunked": chunked}, launches, err_v


def partition_mesh_phase(res, mesh, dev):
    """(d) ``partition(mesh=...)`` on the planted 4-block 2^20-node graph
    (eigsh_mnmg, then kmeans_fit_mnmg on the embedding): the same bar as
    partition_phase (a converged Lanczos, agreement >= 0.99, edge cut
    within 1% of the planted one). After the counted run, fused_lloyd is
    held at the fit's shape (the embedding's 2^20 rows of 4 against a row
    of each block): labels equal its plain version's but at near-ties,
    distances within REL, counts and sums as ``lloyd_sums_f64``."""
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.linalg import contractions as tc
    from raft_tpu_torch.spectral import analyze_partition, partition
    from raft_tpu_torch.spectral.partition import _embedding

    g, truth = planted_graph(res)
    row = g.row_ids().long()
    planted_cut = int((truth[row] != truth[g.indices.long()]).sum()) // 2
    del row
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    labels, vals, vecs, rep = partition(res, g, n_clusters=4, mesh=mesh,
                                        return_report=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cut, cost = analyze_partition(res, g, 4, labels)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    for name in ("csr_spmv", "fused_lloyd"):
        check(launches[name] > 0, f"partition(mesh=...) never launched "
              f"{name}")
    check(rep.converged, f"partition(mesh=...)'s Lanczos did not "
          f"converge: {rep}")
    agree = best_agreement(labels, truth, PLANTED_BLOCKS)
    check(agree >= 0.99, f"partition(mesh=...) recovers the blocks at "
          f"{agree}")
    cut = float(cut)
    check(abs(cut - planted_cut) <= 0.01 * planted_cut,
          f"partition(mesh=...) edge cut {cut} vs planted {planted_cut}")
    emb = _embedding(vecs).contiguous()
    m, k = emb.shape
    # a row of each planted block (node i lies in block i // (m / 4))
    cents = emb[torch.arange(PLANTED_BLOCKS, device=dev) * (
        m // PLANTED_BLOCKS) + 7].contiguous()
    xs, ys = tc._side(emb, "high"), tc._side(cents, "high")
    what = "fused_lloyd at the partition's k-means shape"
    sums, counts, dist, lab = tc._fused_lloyd("high", xs, ys, m,
                                              PLANTED_BLOCKS, k)
    want = tc._lloyd_plain("high", xs, ys, m, PLANTED_BLOCKS, k)
    dscale = ((emb.double() ** 2).sum(1)
              + (cents.double() ** 2).sum(1).max()).float()
    near = labels_agree(lab, want[3], plain_rows("high", "l2", xs, ys,
                                                 PLANTED_BLOCKS, k),
                        dscale, REL, what)
    e = (dist - want[2]).abs()
    check(bool((e <= REL * dscale + 1e-6).all()),
          f"{what}: distances off by {float(e.max())}")
    lloyd_err = max(float(e.max()), lloyd_sums_f64(
        emb, lab, sums, counts, PLANTED_BLOCKS, what)[0])
    del g, truth, labels, vecs, emb, cents, xs, ys, want, sums, dist, lab
    torch.cuda.empty_cache()
    return {"nodes": 1 << RMAT_SCALE, "blocks": PLANTED_BLOCKS,
            "wall_s": wall, "n_iter": rep.n_iter, "converged": rep.converged,
            "eigenvalues": vals.tolist(), "agreement": agree,
            "edge_cut": cut, "planted_cut": planted_cut,
            "ratio_cut_cost": float(cost),
            "fused_lloyd_shape": [m, PLANTED_BLOCKS, k],
            "fused_lloyd_max_abs_err": lloyd_err,
            "fused_lloyd_near_tie_labels": int(near.numel()),
            "launches": {k: v for k, v in launches.items() if v}}, \
        launches, lloyd_err


def comms_mnmg_phase(res, dev, g):
    """The comms layer on a NCCL process group of world size 1, the MNMG
    Lloyd step over it, and the MNMG solvers through their entry points
    (the ``mnmg_fit`` line; ``g`` is config 4's graph), and the sharded
    IVF index (:func:`ivf_mnmg_part`). The process group is destroyed in
    a finally, so the script cannot hang at exit. Returns the launches of
    each counted run, the parity errors at the new shapes, and the IVF
    part with its launches."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from raft_tpu_torch.comms import bootstrap, build_mesh_comms
    from raft_tpu_torch.core import resources as core_res

    check(dist.is_nccl_available(), "NCCL is not available to "
          "torch.distributed")
    torch.cuda.set_device(0)
    bootstrap.initialize_distributed(num_processes=1, process_id=0,
                                     backend="nccl")
    try:
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        comm = build_mesh_comms(res, mesh)
        check(core_res.get_comms(res) is comm and comm.get_size() == 1,
              "build_mesh_comms did not inject a one-rank communicator")
        self_ms = comms_self_tests(res)
        x, c0 = config5_data(dev)
        c5 = config5_step(res, mesh, dev, x, c0)
        fit, fit_l = config5_fit(res, mesh, dev, x, c0)
        del x, c0
        torch.cuda.empty_cache()
        mesh2 = init_device_mesh("cuda", (1, 1),
                                 mesh_dim_names=("data", "model"))
        model = model_axis_step(mesh2, dev)
        knn_out, knn_l, errs = knn_mnmg_phase(res, mesh, dev)
        eig, eig_l, errs["csr_spmv"] = eigsh_mnmg_phase(res, mesh, dev, g)
        part, part_l, errs["fused_lloyd"] = partition_mesh_phase(res, mesh,
                                                                 dev)
        ivf_mnmg, ivf_mnmg_l = ivf_mnmg_part(res, dev)
    finally:
        dist.destroy_process_group()
    routes = nan_probe_card(dev)
    emit("comms_mnmg", backend="nccl", world_size=1,
         self_tests_ms=self_ms, config5=c5, model_axis=model,
         nan_probe_routes=routes)
    emit("mnmg_fit", backend="nccl", world_size=1, config5_fit=fit,
         knn_mnmg=knn_out, eigsh_mnmg=eig, partition_mesh=part)
    mnmg_l = {n: sum(d.get(n, 0) for d in (fit_l, knn_l, eig_l, part_l))
              for n in fit_l}
    return (c5["launches"], model["launches"], c5["against_plain"], mnmg_l,
            errs, ivf_mnmg, ivf_mnmg_l)


# ---------------------------------------------------------------------------
# BASELINE config 2: the dense linalg path at full width
# ---------------------------------------------------------------------------


def c2_rel(got, want):
    """max |got - want| / max |want| over float tensors."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def c2_planted(dev, decay):
    """[C2_M, C2_N] f32 = U diag(decay^i) Vᵀ with seeded orthonormal U, V,
    and its singular values in f64."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    u = torch.linalg.qr(torch.randn(C2_M, C2_N, generator=g,
                                    device=dev)).Q
    v = torch.linalg.qr(torch.randn(C2_N, C2_N, generator=g,
                                    device=dev)).Q
    s = decay ** torch.arange(C2_N, dtype=torch.float64, device=dev)
    return ((u.double() * s) @ v.double().T).float(), s


def c2_gemm(res, a, out):
    """(a) the gram gemm at each tier against an f64 product over
    |a|ᵀ|a|, TF32 turned on globally around the call (the port's scope
    must turn it off), beside f32 cuBLAS with TF32 off."""
    import torch

    from raft_tpu_torch import linalg as tl
    from raft_tpu_torch.linalg.contractions import _split_hi_lo
    from raft_tpu_torch.util import precision as tprec

    a64 = a.double()
    exact = a64.T @ a64
    mass = a64.abs().T @ a64.abs()
    flops = 2.0 * C2_N * C2_N * C2_M
    ab = C2_M * C2_N * 4 + C2_N * C2_N * 4
    passes = {"default": 1, "high": 3}
    saved = torch.backends.cuda.matmul.allow_tf32
    tiers = {}
    seen = []
    orig = torch.mm, torch.bmm, torch.matmul

    def spy(fn):
        def call(*args, **kw):
            seen.append((tier, torch.backends.cuda.matmul.allow_tf32))
            return fn(*args, **kw)
        return call

    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.mm, torch.bmm, torch.matmul = map(spy, orig)
        for tier in TIERS:
            got = tl.gemm(res, a, a, trans_a=True, precision=tier)
            torch.cuda.synchronize()
            check(got.dtype == torch.float32 and got.shape == (C2_N, C2_N),
                  f"config2 gemm {tier}: dtype or shape")
            err = float(((got.double() - exact).abs() / mass).max())
            peak = PEAK_BF16_FLOPS if tier != "highest" else PEAK_F32_FLOPS
            tiers[tier] = {
                "max_err_over_mass": err,
                "ms": cuda_ms(lambda tier=tier: tl.gemm(
                    res, a, a, trans_a=True, precision=tier), 10),
                "bound_ms": max(flops * passes.get(tier, 1) / peak,
                                ab / PEAK_BYTES) * 1e3,
                "bound_by": "operations"}
        torch.mm, torch.bmm, torch.matmul = orig
        check({t for t, _ in seen} == set(TIERS),
              "a gemm tier made no mm, bmm or matmul call")
        check(not any(on for _, on in seen),
              "TF32 was on inside gemm's mm, bmm or matmul calls")
        check(torch.backends.cuda.matmul.allow_tf32,
              "gemm did not restore the caller's TF32 flag")
    finally:
        torch.mm, torch.bmm, torch.matmul = orig
        torch.backends.cuda.matmul.allow_tf32 = saved
    check(tiers["high"]["max_err_over_mass"] <= REL,
          f"config2 gemm 'high' error {tiers['high']['max_err_over_mass']}")
    check(tiers["highest"]["max_err_over_mass"]
          < tiers["high"]["max_err_over_mass"],
          "config2 gemm 'highest' is not tighter than 'high'")
    # bf16x3 with each product one cuBLAS call over the whole depth, the
    # accumulator's truncation unchunked (blas._K_CHUNK's reason)
    hi, lo = _split_hi_lo(a)
    one = sum(torch.mm(x.T, y, out_dtype=torch.float32)
              for x, y in ((hi, hi), (hi, lo), (lo, hi)))
    out["gemm_high_one_call_max_err_over_mass"] = float(
        ((one.double() - exact).abs() / mass).max())
    del hi, lo, one
    with tprec.scope("highest"):
        lib = torch.matmul(a.T, a)
        out["gemm_cublas_f32_ms"] = cuda_ms(lambda: torch.matmul(a.T, a), 10)
    out["gemm_cublas_f32_max_err_over_mass"] = float(
        ((lib.double() - exact).abs() / mass).max())
    out["gemm"] = tiers
    out["gemm_gflop"] = flops / 1e9
    return exact


def c2_norms(res, a, out):
    """(b) row_norm (L2, L1) and normalize against f64."""
    import torch

    from raft_tpu_torch import linalg as tl

    a64 = a.double()
    want = {"l2": (a64 * a64).sum(1), "l1": a64.abs().sum(1)}
    nb = C2_M * C2_N * 4
    rows = {}
    for kind in ("l2", "l1"):
        got = tl.row_norm(res, a, kind)
        err = c2_rel(got, want[kind])
        check(err <= 1e-5, f"config2 row_norm {kind}: rel err {err}")
        rows[f"row_norm_{kind}"] = {
            "rel_err": err,
            "ms": cuda_ms(lambda kind=kind: tl.row_norm(res, a, kind), 20),
            "bound_ms": (nb + C2_M * 4) / PEAK_BYTES * 1e3}
    z = tl.normalize(res, a)
    err = c2_rel(z, a64 / want["l2"].sqrt()[:, None])
    check(err <= 1e-5, f"config2 normalize: rel err {err}")
    rows["normalize"] = {"rel_err": err,
                         "ms": cuda_ms(lambda: tl.normalize(res, a), 20),
                         "bound_ms": 2 * nb / PEAK_BYTES * 1e3}
    out["norms"] = rows


def c2_svd(res, a, out):
    """(c) svd_eig and svd_qr against svdvals of the f64 copy, each
    reconstructing a."""
    import torch

    from raft_tpu_torch import linalg as tl

    s64 = torch.linalg.svdvals(a.double())
    rows = {"svd_gesvdj_rel_err": c2_rel(torch.linalg.svdvals(
        a, driver="gesvdj"), s64)}
    for name in ("svd_eig", "svd_qr"):
        u, s, v = getattr(tl, name)(res, a)
        err = c2_rel(s, s64)
        check(err <= C2_SVD_REL, f"config2 {name}: singular values rel err "
              f"{err}")
        check(tl.evaluate_svd_by_reconstruction(res, a, u, s, v),
              f"config2 {name} does not reconstruct a")
        rows[name] = {"rel_err": err, "ms": cuda_ms(
            lambda name=name: getattr(tl, name)(res, a), 3)}
    out["svd"] = rows


def c2_rsvd(res, a, planted, s_planted, out):
    """(d) rsvd_fixed_rank at k = 64: the planted spectrum's top 64, then
    the time on the bench's data."""
    from raft_tpu_torch import linalg as tl

    _, s, _ = tl.rsvd_fixed_rank(res, planted, C2_RSVD_K)
    want = s_planted[:C2_RSVD_K]
    err = float(((s.double() - want).abs() / want).max())
    check(err <= C2_RSVD_REL, f"config2 rsvd: planted spectrum rel err {err}")
    out["rsvd"] = {"k": C2_RSVD_K, "planted_rel_err": err,
                   "ms": cuda_ms(lambda: tl.rsvd_fixed_rank(
                       res, a, C2_RSVD_K), 3)}


def c2_eig(res, gram, out):
    """(e) eig_dc, eig_sel (top 16: the iterative route, or its fall back)
    and eig_jacobi on the 1024 x 1024 Gram matrix against an f64 eigh, and
    eig_jacobi's rotations as paired row and column updates, timed."""
    import torch

    from raft_tpu_torch import linalg as tl
    from raft_tpu_torch.linalg import eig as teig

    g32 = gram.float()
    w64 = torch.linalg.eigvalsh(gram)
    scale = float(w64.abs().max())
    rows = {}
    w, _ = tl.eig_dc(res, g32)
    err = float((w.double() - w64).abs().max()) / scale
    check(err <= C2_EIG_REL, f"config2 eig_dc: rel err {err}")
    rows["eig_dc"] = {"rel_err": err,
                      "ms": cuda_ms(lambda: tl.eig_dc(res, g32), 3)}
    fell_back = []
    orig = teig._eig_dc_slice

    def spy(*args, **kw):
        fell_back.append(True)
        return orig(*args, **kw)

    teig._eig_dc_slice = spy
    try:
        t0 = time.perf_counter()
        w, _ = tl.eig_sel(res, g32, C2_SEL_K)
        torch.cuda.synchronize()
        sel_ms = (time.perf_counter() - t0) * 1e3
    finally:
        teig._eig_dc_slice = orig
    err = float((w.double() - w64[-C2_SEL_K:]).abs().max()) / scale
    check(err <= C2_EIG_REL, f"config2 eig_sel: rel err {err}")
    rows["eig_sel"] = {"k": C2_SEL_K, "rel_err": err, "ms": sel_ms,
                       "route": "eig_dc slice" if fell_back
                       else "iterative (Lanczos)"}
    t0 = time.perf_counter()
    w, v, rep = tl.eig_jacobi(res, g32, tol=C2_JACOBI_TOL,
                              sweeps=C2_JACOBI_SWEEPS, return_report=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    err = float((w.double() - w64).abs().max()) / scale
    check(err <= C2_JACOBI_REL, f"config2 eig_jacobi: rel err {err}")
    rows["eig_jacobi"] = {
        "form": "dense (the reference's)", "rel_err": err,
        "sweeps": rep.n_iter, "converged": rep.converged,
        "residual": rep.residual, "ms": ms,
        "ms_per_sweep": ms / max(rep.n_iter, 1)}
    out["eig"] = rows


def c2_lstsq(res, a, out):
    """(f) the three lstsq routes with a 1024-column b against an f64
    torch.linalg.lstsq."""
    import torch

    from raft_tpu_torch import linalg as tl

    g = torch.Generator(device=a.device).manual_seed(SEED + 22)
    b = torch.randn(C2_M, C2_N, generator=g, device=a.device)
    want = torch.linalg.lstsq(a.double(), b.double()).solution
    rows = {}
    for name in ("lstsq_svd_qr", "lstsq_eig", "lstsq_qr"):
        got = getattr(tl, name)(res, a, b)
        err = c2_rel(got, want)
        check(err <= C2_LSTSQ_REL, f"config2 {name}: rel err {err}")
        rows[name] = {"rel_err": err, "ms": cuda_ms(
            lambda name=name: getattr(tl, name)(res, a, b), 3)}
    out["lstsq"] = rows


def c2_pca(res, x, steep, out):
    """(g) pca_fit (COV_EIG_DQ, RANDOMIZED), tsvd_fit, and pca_partial_fit
    over the same rows in C2_CHUNK-row chunks then pca_finalize, whose
    components must match pca_fit's (both sign-flipped), on ``x`` (a
    planted spectrum of C2_PCA_DECAY, gaps wide enough for 64 f32
    components); the randomized solver against the exact fit on
    ``steep`` (C2_RSVD_DECAY: a randomized sketch needs a decaying
    spectrum)."""
    import torch

    from raft_tpu_torch import linalg as tl

    k = C2_PCA_K
    rnd_solver = tl.Solver.RANDOMIZED
    full = tl.pca_fit(res, x, k)
    tsvd = tl.tsvd_fit(res, x, k)
    inc = tl.pca_finalize(res, tl.pca_partial_fit(res, x,
                                                  chunk_rows=C2_CHUNK), k)
    comp_err = float((inc.components - full.components).abs().max())
    var_err = c2_rel(inc.explained_variance, full.explained_variance)
    check(comp_err <= C2_PCA_ATOL and var_err <= 1e-4,
          f"config2 pca_partial_fit: components {comp_err}, variance "
          f"{var_err}")
    rnd_err = c2_rel(tl.pca_fit(res, steep, k, solver=rnd_solver)
                     .explained_variance,
                     tl.pca_fit(res, steep, k).explained_variance)
    check(rnd_err <= 1e-4, f"config2 pca RANDOMIZED: variance rel err "
          f"{rnd_err}")
    check(bool(torch.isfinite(tsvd.components).all()), "config2 tsvd")
    out["pca"] = {
        "k": k, "chunk_rows": C2_CHUNK,
        "partial_vs_fit_component_max_abs": comp_err,
        "partial_vs_fit_variance_rel": var_err,
        "randomized_variance_rel": rnd_err,
        "pca_fit_ms": cuda_ms(lambda: tl.pca_fit(res, x, k), 3),
        "pca_fit_randomized_ms": cuda_ms(lambda: tl.pca_fit(
            res, x, k, solver=rnd_solver), 3),
        "tsvd_fit_ms": cuda_ms(lambda: tl.tsvd_fit(res, x, k), 3),
        "partial_fit_ms": cuda_ms(lambda: tl.pca_partial_fit(
            res, x, chunk_rows=C2_CHUNK), 3),
        "finalize_ms": cuda_ms(lambda: tl.pca_finalize(
            res, tl.pca_partial_fit(res, x, chunk_rows=C2_CHUNK), k), 1)}


def c2_keyed(res, a, out):
    """(h) reduce_rows_by_key at C2_M x C2_N with C2_KEYS keys, weighted
    and not, and reduce_cols_by_key over C2_COL_KEYS column keys, with
    the launch counts set to 0 just before; csr_spmm at these shapes
    against its plain version and an f64 sum, and beside cuSPARSE.
    Returns (launches, max abs error against the plain version, the
    keyed shape's numbers for the kernels line)."""
    import importlib
    import warnings

    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch import linalg as tl
    from raft_tpu_torch.sparse import grid_spmv as tg

    red = importlib.import_module("raft_tpu_torch.linalg.reduce")
    dev = a.device
    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    keys = torch.randint(0, C2_KEYS, (C2_M,), generator=g, device=dev,
                         dtype=torch.int32)
    w = torch.rand(C2_M, generator=g, device=dev) + 0.5
    col_keys = torch.randint(0, C2_COL_KEYS, (C2_N,), generator=g,
                             device=dev, dtype=torch.int32)
    kernels.reset_launch_counts()
    plain_w = tl.reduce_rows_by_key(res, a, keys, C2_KEYS)
    weighted = tl.reduce_rows_by_key(res, a, keys, C2_KEYS, weights=w)
    cols = tl.reduce_cols_by_key(res, a, col_keys, C2_COL_KEYS)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check(launches["csr_spmm"] > 0, "config2's keyed sums never launched "
          "csr_spmm")
    errs = []
    cases = (("rows", keys, None, a, C2_KEYS, plain_w),
             ("rows_weighted", keys, w, a, C2_KEYS, weighted),
             ("cols", col_keys, None, a.T.contiguous(), C2_COL_KEYS, cols.T))
    shapes = {}
    for what, kk, ww, b, nk, got in cases:
        ind = red._key_csr(kk.long(), torch.ones_like(kk, dtype=torch.bool),
                           nk, torch.float32, ww)
        want = tg._spmm_plain(*ind, b, nk)
        errs.append(check_csr_product(got.contiguous(), want, *ind, b,
                                      f"config2 keyed {what}"))
        # the f64 sum is grouped by index_add_, not through the CSR
        b64 = b.double() if ww is None else b.double() * ww.double()[:, None]
        f64 = torch.zeros(nk, b.shape[1], dtype=torch.float64,
                          device=dev).index_add_(0, kk.long(), b64)
        mass = torch.zeros_like(f64).index_add_(0, kk.long(), b64.abs())
        del b64
        check(bool(((got.double() - f64).abs()
                    <= SPARSE_REL * mass + SPARSE_REL).all()),
              f"config2 keyed {what}: against the f64 sum")
        bound, nbytes = spmv_bound(int(ind[0][-1]), nk, b.shape[0],
                                   b.shape[1], 8)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            lib = torch.sparse_csr_tensor(ind[0].to(torch.int32), *ind[1:],
                                          size=(nk, b.shape[0]))
        shapes[what] = {
            "shape": [nk, b.shape[0], b.shape[1]],
            "kernel_ms": cuda_ms(lambda ind=ind, b=b, nk=nk: tg._spmm(
                *ind, b, nk), 20),
            "call_ms": cuda_ms({
                "rows": lambda: tl.reduce_rows_by_key(res, a, keys, C2_KEYS),
                "rows_weighted": lambda: tl.reduce_rows_by_key(
                    res, a, keys, C2_KEYS, weights=w),
                "cols": lambda: tl.reduce_cols_by_key(
                    res, a, col_keys, C2_COL_KEYS)}[what], 10),
            "plain_ms": cuda_ms(lambda ind=ind, b=b, nk=nk: tg._spmm_plain(
                *ind, b, nk), 5),
            "bound_ms": bound, "bytes": nbytes,
            "library_ms": cuda_ms(lambda lib=lib, b=b: lib @ b, 20),
            "library_call": "torch.sparse_csr_tensor(...) @ B (cuSPARSE)"}
    out["keyed"] = shapes
    return launches, max(errs), shapes["rows"]


def config2_phase(res, dev):
    """BASELINE config 2 at full width (bench_prims.py:236-257): the gram
    gemm at each tier, row norms, the SVDs, the randomized SVD, the
    eigensolvers on the Gram matrix, lstsq, PCA, and the keyed sums on
    csr_spmm. Returns the keyed sums' (launches, max abs error, numbers
    at the keyed shape)."""
    import torch

    t_start = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    a = torch.randn(C2_M, C2_N, generator=g, device=dev)
    out = {"shape": [C2_M, C2_N]}
    exact = c2_gemm(res, a, out)
    c5_phase(res, a)
    c2_norms(res, a, out)
    c2_svd(res, a, out)
    steep, s_steep = c2_planted(dev, C2_RSVD_DECAY)
    c2_rsvd(res, a, steep, s_steep, out)
    c2_eig(res, exact, out)
    del exact
    c2_lstsq(res, a, out)
    x, _ = c2_planted(dev, C2_PCA_DECAY)
    c2_pca(res, x, steep, out)
    c2_pca_chunks(res, x, out)
    del x, steep
    launches, keyed_err, keyed_row = c2_keyed(res, a, out)
    out["launches"] = {n: c for n, c in launches.items() if c}
    out["seconds"] = time.perf_counter() - t_start
    emit("config2", **out)
    del a
    torch.cuda.empty_cache()
    return launches, keyed_err, keyed_row


# ---------------------------------------------------------------------------
# IVF: IVF-Flat, IVF-PQ and the sharded IVF-Flat at the reference's bench
# families' full shapes (bench_prims.py:1163-1262)
# ---------------------------------------------------------------------------


def ivf_recall(ids, truth):
    """recall@k: the share of the true k nearest ids that came back."""
    hit = (ids.long()[:, :, None] == truth.long()[:, None, :]).any(-1)
    return float(hit.float().mean())


def ivf_agree(got, want, q, x, what):
    """IVF results against another run of the same search: distances
    within REL of |q|^2 + max|x|^2, ids equal except where the two rows'
    exact (f64) distances to the query lie within that band. Returns the
    count of differing ids and the max abs error."""
    import torch

    (gv, gi), (wv, wi) = got, (a.to(got[0].device) for a in want)
    scale = (q.double() ** 2).sum(1) + float((x.double() ** 2).sum(1).max())
    fin = torch.isfinite(wv)
    check(torch.equal(torch.isfinite(gv), fin), f"{what}: +inf pads differ")
    err = (gv - wv).abs().double()
    band = (REL * scale)[:, None].expand_as(err)
    check(bool((err <= band + 1e-6)[fin].all()),
          f"{what}: distances off by {float(err[fin].max())}")
    bad = torch.nonzero(gi != wi).tolist()
    check(len(bad) <= max(1, gi.numel() // 100),
          f"{what}: {len(bad)} of {gi.numel()} ids differ")
    for r, c in bad:
        dg, dw = (float(((q[r].double() - x[int(i[r, c])].double()) ** 2)
                        .sum()) for i in (gi, wi))
        check(int(gi[r, c]) >= 0 and int(wi[r, c]) >= 0
              and abs(dg - dw) <= REL * float(scale[r]),
              f"{what}: ids {int(gi[r, c])} vs {int(wi[r, c])} differ "
              "outside the tie band")
    return len(bad), float(err[fin].max()) if bool(fin.any()) else 0.0


def ivf_breakdown(fn, reps=3, top=6):
    """Where one search's device time goes, from a trace of ``reps``
    calls: its busy and span ms, the card's idle share between its first
    and last op, and the ``top`` device ops by time (ms a call)."""
    events, *_ = device_trace(fn, reps)
    span = max(e for _, _, e in events) - min(s for _, s, _ in events)
    busy = busy_us(events)
    by_name = {}
    for name, s, e in events:
        # a name's first 160 characters: templated kernels share their
        # first 80 and differ further on
        key = name[:160]
        by_name[key] = by_name.get(key, 0.0) + (e - s) / reps / 1e3
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(busy_ms=busy / reps / 1e3, span_ms=span / reps / 1e3,
                idle_share=1.0 - busy / span, device_ops=len(events) // reps,
                top_ops_ms=dict(ops))


def ivf_counts(kernels, part, names):
    """This part's launches, each of ``names`` at least once."""
    counts = kernels.launch_counts()
    for name in names:
        check(counts[name] > 0, f"ivf {part} never launched {name}")
    return {n: c for n, c in counts.items() if c}


def ivf_launched(kernels, fn):
    """``fn()`` and the launches it made, by kernel."""
    before = kernels.launch_counts()
    out = fn()
    after = kernels.launch_counts()
    return out, {n: after[n] - before[n] for n in after
                 if after[n] != before[n]}


def ivf_peak(op, fn, per_row):
    """Device bytes one search allocates beyond what was live before it
    (``torch.cuda.max_memory_allocated``), beside the reference's
    estimate of its query rows (``per_row`` each) and the port's
    (``ivf_flat._port_bytes``, which the work budget admits by); fails
    where the port's estimate is short of the peak. Emits an
    ``ivf_memory`` line first, so a miss still shows its numbers."""
    import torch

    from raft_tpu_torch.neighbors import ivf_flat

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    row = dict(op=op, peak_bytes=torch.cuda.max_memory_allocated() - base,
               reference_estimate=per_row * IVF_Q,
               port_estimate=ivf_flat._port_bytes(op, IVF_Q, per_row, 0))
    row["peak_over_reference"] = row["peak_bytes"] / row["reference_estimate"]
    del out
    emit("ivf_memory", **row)
    check(row["peak_bytes"] <= row["port_estimate"],
          f"{op}: the search allocated {row['peak_bytes']} bytes, more than "
          f"the port's estimate {row['port_estimate']}")
    return row


def ivf_flat_part(res, dev):
    """neighbors/ivf_recall: build at 2^20 x 64 with 1024 lists, searches
    at k = 10 and nprobe 1, 4, 16 and 1024, and at k = 64, nprobe 16 (the
    radix route); the full probe bitwise knn, recall@10 at nprobe 16 over
    the reference's floor, nprobe 16 on 64 queries against the same
    search on the CPU, and extend against a rebuild on both branches."""
    import numpy as np
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.neighbors import ivf_flat, ivf_mnmg, knn

    from raft_tpu_torch.runtime import limits

    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    x = blobs(gen, dev, IVF_N, IVF_D, IVF_LISTS)
    q = x[:IVF_Q].clone()
    # brute force's answers, before the counts: only IVF's calls count
    truth = {k: knn(res, x, q, k) for k in (10, IVF_RADIX_K)}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    idx = ivf_flat.build(res, x, IVF_LISTS, seed=0, max_iter=IVF_ITERS)
    torch.cuda.synchronize()
    out = {"db": [IVF_N, IVF_D], "n_lists": IVF_LISTS, "queries": IVF_Q,
           "max_iter": IVF_ITERS, "build_s": time.perf_counter() - t0,
           "cap_max": idx.cap_max}
    runs, each = {}, {}
    for k, nprobe in IVF_FLAT_SEARCHES:
        runs[(k, nprobe)], each[(k, nprobe)] = ivf_launched(
            kernels, lambda: ivf_flat.search(res, idx, q, k, nprobe))
    # the extend checks: every free tail slot filled by rows next to
    # their list's centroid (the append branch), then 4096 rows more
    # than the tails hold (the repack branch); each against a rebuild
    # with the same centroids
    room = torch.from_numpy(idx.caps) - idx.sizes.cpu().long()
    lists = torch.repeat_interleave(torch.arange(IVF_LISTS), room).to(dev)
    tail = idx.centroids[lists] + 0.01 * torch.randn(
        lists.shape[0], IVF_D, generator=gen, device=dev)
    extra = blobs(gen, dev, IVF_EXTEND, IVF_D, 16)
    extends = {}
    for branch, rows in (("append", tail), ("repack", extra)):
        ext = ivf_flat.extend(res, idx, rows)
        reb = ivf_flat.build(res, torch.cat([x, rows]), IVF_LISTS,
                             centroids=idx.centroids)
        check(np.array_equal(ext.caps, idx.caps) == (branch == "append"),
              f"ivf extend took the wrong branch for {branch}")
        got = ivf_flat.search(res, ext, q, 10, 16)
        want = ivf_flat.search(res, reb, q, 10, 16)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"ivf extend ({branch}) differs from the rebuild")
        extends[branch] = dict(rows=int(rows.shape[0]), bitwise_rebuild=True)
        del ext, reb, got, want
    torch.cuda.synchronize()
    launches = ivf_counts(kernels, "flat", (
        "fused_lloyd", "fused_argmin", "radix_threshold", "radix_emit",
        "fused_topk"))
    check(each[(10, IVF_LISTS)].get("fused_topk", 0) > 0,
          "ivf's full probe never launched fused_topk")
    check(all(each[(IVF_RADIX_K, 16)].get(n, 0) > 0
              for n in ("radix_threshold", "radix_emit")),
          "ivf k=64 at nprobe 16 never launched the radix kernels")
    out["extend"] = extends
    knn_ms = {k: cuda_ms(lambda k=k: knn(res, x, q, k), 5)
              for k in (10, IVF_RADIX_K)}
    searches = []
    for (k, nprobe), (d, i) in runs.items():
        check(tuple(i.shape) == (IVF_Q, k) and i.dtype == torch.int32,
              f"ivf k={k} nprobe={nprobe}: output")
        ms = cuda_ms(lambda: ivf_flat.search(res, idx, q, k, nprobe), 5)
        searches.append(dict(
            k=k, nprobe=nprobe, ms=ms, queries_per_s=IVF_Q / ms * 1e3,
            recall_at_k=ivf_recall(i, truth[k][1]),
            scanned_fraction=idx.scanned_fraction(nprobe),
            speedup_vs_knn=knn_ms[k] / ms,
            radix=nprobe < IVF_LISTS and ivf_flat._use_radix(
                nprobe * idx.cap_max, k), launches=each[(k, nprobe)]))
    out["knn_ms"] = knn_ms
    out["searches"] = searches
    sizes = idx.sizes.float()
    out["list_sizes"] = dict(min=int(sizes.min()), median=float(
        sizes.median()), max=int(sizes.max()))
    out["tile_fill"] = IVF_N / (IVF_LISTS * idx.cap_max)
    out["nprobe16_breakdown"] = ivf_breakdown(
        lambda: ivf_flat.search(res, idx, q, 10, 16))
    full = runs[(10, IVF_LISTS)]
    check(all(torch.equal(a, b) for a, b in zip(full, truth[10])),
          "ivf full probe is not bitwise knn")
    r16 = next(s["recall_at_k"] for s in searches
               if (s["k"], s["nprobe"]) == (10, 16))
    check(r16 >= IVF_RECALL_FLOOR,
          f"ivf recall@10 at nprobe 16 is {r16} < {IVF_RECALL_FLOOR}")
    check(next(s["radix"] for s in searches if s["k"] == IVF_RADIX_K),
          "ivf k=64 at nprobe 16 did not take the radix route")
    # the same searches on the CPU, where the plain versions run: the
    # key sort at k = 10, the radix select's at k = 64
    sample, host = q[:IVF_CPU_Q], ivf_mnmg._host_flat(idx)
    out["vs_cpu"] = []
    for k in (10, IVF_RADIX_K):
        want = ivf_flat.search(None, host, sample.cpu(), k, 16)
        got = ivf_flat.search(res, idx, sample, k, 16)
        differ, err = ivf_agree(got, want, sample, x,
                                f"ivf k={k} nprobe 16 vs CPU")
        out["vs_cpu"].append(dict(queries=IVF_CPU_Q, k=k, nprobe=16,
                                  differing_ids=differ, max_abs_err=err))
    del host
    out["memory"] = [ivf_peak(
        "neighbors.ivf_search",
        lambda k=k: ivf_flat.search(res, idx, q, k, 16),
        limits.estimate_bytes("neighbors.ivf_search", n_queries=1,
                              probe_rows=16 * idx.cap_max, n_dims=IVF_D,
                              k=k, itemsize=4)) for k in (10, IVF_RADIX_K)]
    out["full_probe_bitwise_knn"] = True
    out["launches"] = launches
    KEPT["ivf_flat"] = idx                 # the serve phase's index
    del x, q, idx, truth, runs
    torch.cuda.empty_cache()
    return out, launches


def ivf_pq_part(res, dev):
    """neighbors/ivf_pq_recall: 2^20 x 128, the coarse fit as an IVF-Flat
    build (1024 lists), codebooks (m = 16, nbits 8, 10 iterations) and
    the encode; the (nprobe, refine) sweep at k = 10, the compression
    ratio, the full probe bitwise knn on raw(), the one-hot and gather
    LUT sums bitwise on 16 queries; then the encode's fused argmin and
    the codebooks' Lloyd pass at [65,536 x 8] x [256 x 8] against their
    plain versions. Returns the line's part, its launches and the two
    kernels' numbers at that shape."""
    import torch

    import dataclasses

    from raft_tpu_torch import kernels
    from raft_tpu_torch.linalg import contractions as tc
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq, knn
    from raft_tpu_torch.runtime import limits

    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    x = blobs(gen, dev, IVF_N, PQ_D, IVF_LISTS)
    q = x[:IVF_Q].clone()
    truth = knn(res, x, q, 10)          # brute force, before the counts
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    flat = ivf_flat.build(res, x, IVF_LISTS, seed=0, max_iter=IVF_ITERS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    flat_bytes = sum(a.nbytes for a in (flat.packed_db, flat.packed_ids,
                                        flat.centroids, flat.starts,
                                        flat.sizes))
    centroids = flat.centroids
    del flat
    pq = ivf_pq.build(res, x, IVF_LISTS, m=PQ_M, nbits=PQ_NBITS,
                      pq_max_iter=PQ_ITERS, seed=0, centroids=centroids)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    again = ivf_pq.build(res, x, IVF_LISTS, m=PQ_M, nbits=PQ_NBITS,
                         centroids=pq.centroids, codebooks=pq.codebooks)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    check(torch.equal(again.packed_codes, pq.packed_codes)
          and torch.equal(again.packed_ids, pq.packed_ids),
          "ivf_pq: a rebuild from the same quantizers encodes differently")
    del again
    out = {"db": [IVF_N, PQ_D], "n_lists": IVF_LISTS, "m": PQ_M,
           "nbits": PQ_NBITS, "pq_max_iter": PQ_ITERS, "queries": IVF_Q,
           "cap_max": pq.cap_max, "coarse_fit_s": t1 - t0,
           "codebooks_and_encode_s": t2 - t1,
           "encode_s": t3 - t2, "codebooks_s": (t2 - t1) - (t3 - t2),
           "flat_bytes": int(flat_bytes), "device_bytes": pq.device_bytes(),
           "compression_ratio": flat_bytes / pq.device_bytes()}
    check(out["compression_ratio"] >= 8,
          f"ivf_pq compression {out['compression_ratio']} < 8")
    runs, each = {}, {}
    for nprobe, refine in PQ_SWEEP:
        runs[(nprobe, refine)], each[(nprobe, refine)] = ivf_launched(
            kernels, lambda: ivf_pq.search(res, pq, q, 10, nprobe,
                                           refine=refine))
    lut = [ivf_pq._search_body(
        q[:PQ_LUT_Q], pq.centroids, pq.codebooks, pq.packed_codes,
        pq.packed_ids, pq.starts, pq.sizes, k=10, nprobe=16,
        cap_max=pq.cap_max, metric="l2", use_radix=False, use_onehot=oh)
        for oh in (True, False)]
    torch.cuda.synchronize()
    launches = ivf_counts(kernels, "pq", (
        "fused_lloyd", "fused_argmin", "radix_threshold", "radix_emit",
        "fused_topk"))
    check(each[PQ_FULL].get("fused_topk", 0) > 0,
          "ivf_pq's full probe never launched fused_topk")
    check(all(each[(16, 40)].get(n, 0) > 0
              for n in ("radix_threshold", "radix_emit")),
          "ivf_pq (16, 40) never launched the radix kernels")
    check(all(torch.equal(a, b) for a, b in zip(*lut)),
          "ivf_pq one-hot and gather LUT sums differ")
    full = runs[PQ_FULL]
    check(all(torch.equal(a, b) for a, b in zip(
        full, knn(res, pq.raw(), q, 10))), "ivf_pq full probe is not "
          "bitwise knn on raw()")
    knn_ms = cuda_ms(lambda: knn(res, x, q, 10), 5)
    searches = []
    for (nprobe, refine), (d, i) in runs.items():
        ms = cuda_ms(lambda: ivf_pq.search(res, pq, q, 10, nprobe,
                                           refine=refine), 5)
        searches.append(dict(
            nprobe=nprobe, refine=refine, ms=ms,
            queries_per_s=IVF_Q / ms * 1e3,
            recall_at_k=ivf_recall(i, truth[1]),
            scanned_fraction=pq.scanned_fraction(nprobe),
            speedup_vs_knn=knn_ms / ms, launches=each[(nprobe, refine)]))
    # (16, 0) and (16, 40) on the CPU, where the plain versions run (the
    # ADC top-40 by the radix select's): ADC distances score the decoded
    # rows, refined ones the raw rows
    host = dataclasses.replace(
        pq, _raw_cache=None, **{f: getattr(pq, f).cpu() for f in (
            "centroids", "codebooks", "packed_codes", "packed_ids",
            "starts", "sizes")})
    decoded = torch.from_numpy(pq.decode()).to(dev)
    sample = q[:IVF_CPU_Q]
    out["vs_cpu"] = []
    for nprobe, refine in ((16, 0), (16, 40)):
        want = ivf_pq.search(None, host, sample.cpu(), 10, nprobe,
                             refine=refine)
        got = ivf_pq.search(res, pq, sample, 10, nprobe, refine=refine)
        differ, err = ivf_agree(got, want, sample,
                                x if refine else decoded,
                                f"ivf_pq ({nprobe}, {refine}) vs CPU")
        out["vs_cpu"].append(dict(
            queries=IVF_CPU_Q, nprobe=nprobe, refine=refine,
            differing_ids=differ, max_abs_err=err))
    del host, decoded
    out["memory"] = [ivf_peak(
        "neighbors.ivf_pq_search",
        lambda r=r: ivf_pq.search(res, pq, q, 10, 16, refine=r),
        limits.estimate_bytes(
            "neighbors.ivf_pq_search", n_queries=1, nprobe=16,
            probe_rows=16 * pq.cap_max, n_dims=PQ_D, k=max(10, r), m=PQ_M,
            n_codes=1 << PQ_NBITS, refine=r, itemsize=4)) for r in (0, 40)]
    out.update(knn_ms=knn_ms, searches=searches, launches=launches,
               full_probe_bitwise_knn=True, lut_sums_bitwise=PQ_LUT_Q,
               tile_fill=IVF_N / (IVF_LISTS * pq.cap_max),
               nprobe16_breakdown=ivf_breakdown(
                   lambda: ivf_pq.search(res, pq, q, 10, 16)))
    # the encode's and the codebook fit's shape: the first chunk's first
    # subspace against its codebook, at 'high'
    lab = torch.from_numpy(ivf_flat._coarse_labels(
        x[:PQ_CHUNK], pq.centroids)).to(dev).long()
    sub = (x[:PQ_CHUNK] - pq.centroids[lab])[:, :PQ_D // PQ_M].contiguous()
    book = pq.codebooks[0].contiguous()
    m, n, k = PQ_CHUNK, 1 << PQ_NBITS, PQ_D // PQ_M
    xs, ys = tc._side(sub, "high"), tc._side(book, "high")
    argmin_row = argmin_shape("high", "l2", xs, ys, m, n, k, m,
                              lambda: cdist_argmin(sub, book),
                              "torch.cdist + argmin", 20)
    want = tc._lloyd_plain("high", xs, ys, m, n, k)
    dscale = argmin_scale("l2", xs, ys, m)
    _, lloyd_err = lloyd_parity("high", xs, ys, want, m, n, k, dscale,
                                "fused_lloyd at the PQ codebook shape")
    lloyd_row = dict(
        shape=[m, n, k], tier="high", max_abs_err=lloyd_err,
        ms=cuda_ms(lambda: tc._fused_lloyd("high", xs, ys, m, n, k), 20),
        plain_ms=cuda_ms(lambda: tc._lloyd_plain("high", xs, ys, m, n, k),
                         2))
    lloyd_row["bound_ms"], lloyd_row["bound_by"] = bound(
        "high", m, n, k, 8 * m + 4 * n * (k + 1))
    out["encode_shape"] = {"fused_argmin": argmin_row,
                           "fused_lloyd": lloyd_row}
    KEPT["ivf_pq"] = pq                    # the serve phase's index
    del x, q, pq, truth, runs, lut, sub, book, xs, ys, want
    torch.cuda.empty_cache()
    return out, launches, argmin_row, lloyd_row


def ivf_mnmg_part(res, dev):
    """neighbors/ivf_mnmg_scaling at world size 1 (inside the NCCL group):
    2^18 x 64, 256 lists, nprobe 16, k = 10 (and k = 64, the radix
    route); the launches of the sharding and the sharded searches alone;
    search_mnmg bitwise ivf_flat.search on the same flat index,
    search_local + merge_pool
    bitwise search_mnmg, shrink_mnmg to one survivor equal to a fresh
    build_mnmg shard for shard."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from raft_tpu_torch import kernels
    from raft_tpu_torch.neighbors import ivf_flat, ivf_mnmg
    from raft_tpu_torch.util import precision as tprec

    mesh = init_device_mesh("cuda", (1,),
                             mesh_dim_names=(ivf_mnmg.DEFAULT_AXIS,))
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    x = blobs(gen, dev, MNMG_IVF_N, IVF_D, MNMG_IVF_LISTS)
    q = x[:IVF_Q].clone()
    k, nprobe = 10, MNMG_IVF_NPROBE
    with tprec.scope("high"):
        flat = ivf_flat.build(res, x, MNMG_IVF_LISTS, seed=0,
                              max_iter=IVF_ITERS)
        # the counts cover the sharding and the sharded searches alone
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        idx = ivf_mnmg.build_mnmg(res, None, MNMG_IVF_LISTS, 1, flat=flat,
                                  mesh=mesh)
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        got = ivf_mnmg.search_mnmg(res, idx, q, k, nprobe)
        got64 = ivf_mnmg.search_mnmg(res, idx, q, IVF_RADIX_K, nprobe)
        torch.cuda.synchronize()
        launches = ivf_counts(kernels, "mnmg",
                              ("radix_threshold", "radix_emit"))
        single = ivf_flat.search(res, flat, q, k, nprobe)
        single64 = ivf_flat.search(res, flat, q, IVF_RADIX_K, nprobe)
        vals, ids = ivf_mnmg.search_local(idx, 0, q, k, nprobe)
        halves = ivf_mnmg.merge_pool(vals[None], ids[None], k, idx.metric)
        shrunk = ivf_mnmg.shrink_mnmg(idx, (0,), mesh=mesh)
        fresh = ivf_mnmg.build_mnmg(res, None, MNMG_IVF_LISTS, 1, flat=flat,
                                    mesh=mesh)
        torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, single))
          and all(torch.equal(a, b) for a, b in zip(got64, single64)),
          "search_mnmg is not bitwise ivf_flat.search")
    check(all(torch.equal(a, b) for a, b in zip(halves, got)),
          "search_local + merge_pool is not bitwise search_mnmg")
    check(all(np.array_equal(getattr(shrunk, a), getattr(fresh, a))
              for a in ("owner", "packed_db_sh", "packed_ids_sh",
                        "starts_sh", "sizes_sh"))
          and all(torch.equal(a, b) for a, b in zip(shrunk.local,
                                                     fresh.local)),
          "shrink_mnmg to one survivor differs from a fresh build_mnmg")
    with tprec.scope("high"):
        ms = cuda_ms(lambda: ivf_mnmg.search_mnmg(res, idx, q, k, nprobe),
                     10)
        single_ms = cuda_ms(lambda: ivf_flat.search(res, flat, q, k, nprobe),
                            10)
    out = dict(db=[MNMG_IVF_N, IVF_D], n_lists=MNMG_IVF_LISTS, k=k,
               bitwise_k=[k, IVF_RADIX_K],
               nprobe=nprobe, queries=IVF_Q, world_size=1, shard_s=shard_s,
               ms=ms, single_rank_ms=single_ms, bitwise_single_rank=True,
               bitwise_halves=True, shrink_equals_fresh=True,
               launches=launches)
    del x, q, flat, idx, shrunk, fresh
    torch.cuda.empty_cache()
    return out, launches


def ivf_phase(res, dev):
    """IVF-Flat and IVF-PQ at full width, at tier 'high' (the sharded
    part runs in comms_mnmg_phase's process group). Returns the parts,
    the launches of each kernel and the PQ shape's kernel numbers."""
    from raft_tpu_torch.util import precision as tprec

    t0 = time.perf_counter()
    with tprec.scope("high"):
        flat, flat_l = ivf_flat_part(res, dev)
        pq, pq_l, argmin_row, lloyd_row = ivf_pq_part(res, dev)
    launches = {n: flat_l.get(n, 0) + pq_l.get(n, 0)
                for n in set(flat_l) | set(pq_l)}
    return dict(flat=flat, pq=pq, seconds=time.perf_counter() - t0), \
        launches, argmin_row, lloyd_row


# ---------------------------------------------------------------------------
# stats: generate data, fit it and score the fit (the cuML evaluation
# workflow) at config 3's shape
# ---------------------------------------------------------------------------


def stats_part(kernels, launches, part, fn):
    """``fn()`` once, with the launch counts set to 0 just before it and
    read just after into ``launches[part]``. Returns ``fn()``'s value and
    its wall seconds (synchronized)."""
    import torch

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches[part] = {n: c for n, c in kernels.launch_counts().items() if c}
    return out, wall


def stats_generate(res, kernels, launches, out):
    """make_blobs at 1M x 128, 1024 centers: exact round-robin counts,
    each cluster's noise mean within 6 sigma / sqrt(count) of 0 in every
    dimension, the overall noise std within 1% of 1.0."""
    import torch

    from raft_tpu_torch import random as trand

    (x, truth, centers), wall = stats_part(
        kernels, launches, "generate",
        lambda: trand.make_blobs(res, trand.RngState(SEED + 40), STATS_M,
                                 STATS_D, n_clusters=STATS_K,
                                 cluster_std=1.0, center_box=(-10.0, 10.0)))
    counts = torch.bincount(truth.long(), minlength=STATS_K)
    want = torch.bincount(torch.arange(STATS_M, device=x.device) % STATS_K,
                          minlength=STATS_K)
    check(torch.equal(counts, want), "make_blobs: labels not round-robin")
    check(int(counts.min()) == STATS_M // STATS_K
          and int(counts.max()) == -(-STATS_M // STATS_K),
          "make_blobs: counts outside 976..977")
    lo, hi = float(centers.min()), float(centers.max())
    check(-10.0 <= lo and hi < 10.0, "make_blobs: centers outside the box")
    noise = (x - centers[truth.long()]).double()
    means = torch.zeros(STATS_K, STATS_D, dtype=torch.float64,
                        device=x.device).index_add_(0, truth.long(), noise)
    means /= counts.double()[:, None]
    z = float((means.abs() * counts.double().sqrt()[:, None]).max())
    std = float(noise.std())
    del noise
    check(z <= 6.0, f"make_blobs: a cluster's noise mean at {z} sigma")
    check(abs(std - 1.0) <= 0.01, f"make_blobs: noise std {std}")
    out["generate"] = dict(shape=[STATS_M, STATS_D], n_clusters=STATS_K,
                           seconds=wall, counts=[int(counts.min()),
                                                 int(counts.max())],
                           max_mean_sigma=z, noise_std=std)
    return x, truth


def stats_scores_f64(a, b):
    """The six external scores in f64 numpy from a host np.bincount
    contingency table, in their textbook forms."""
    import numpy as np

    na, nb = int(a.max()) + 1, int(b.max()) + 1
    c = np.bincount(a * nb + b, minlength=na * nb).reshape(na, nb).astype(
        np.float64)
    n = c.sum()

    def comb(v):
        return v * (v - 1.0) / 2.0

    sij, sa, sb, tot = (comb(c).sum(), comb(c.sum(1)).sum(),
                        comb(c.sum(0)).sum(), comb(n))
    expected = sa * sb / tot
    pi, pj = c.sum(1) / n, c.sum(0) / n
    nz = c > 0
    pij = c[nz] / n
    mi = float(np.sum(pij * np.log(pij / np.outer(pi, pj)[nz])))

    def ent(p):
        p = p[p > 0]
        return -float(np.sum(p * np.log(p)))

    hom = mi / ent(pi)                  # 1 - H(A|B) / H(A)
    com = mi / ent(pj)
    return dict(rand_index=(tot + 2.0 * sij - sa - sb) / tot,
                adjusted_rand_index=(sij - expected)
                / (0.5 * (sa + sb) - expected),
                mutual_info_score=mi, homogeneity_score=hom,
                completeness_score=com,
                v_measure=2.0 * hom * com / (hom + com))


def stats_external(truth, fit, launches, kernels, out):
    """The six external scores of the fit against the blobs' labels on
    the card (a 1024 x 1024 contingency), each within 1e-12 relative of
    the f64 numpy forms, and timed (mean of 3 calls after this one)."""
    import torch

    from raft_tpu_torch import stats as tstats

    names = ("rand_index", "adjusted_rand_index", "mutual_info_score",
             "homogeneity_score", "completeness_score", "v_measure")
    got, _ = stats_part(kernels, launches, "scores",
                        lambda: {n: float(getattr(tstats, n)(truth, fit))
                                 for n in names})
    want = stats_scores_f64(truth.cpu().numpy(), fit.cpu().numpy())
    row = {}
    for n in names:
        err = abs(got[n] - want[n]) / abs(want[n])
        check(err <= 1e-12, f"stats {n}: {got[n]} against f64 {want[n]}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            float(getattr(tstats, n)(truth, fit))
        row[n] = dict(value=got[n], f64=want[n], rel_err=err,
                      ms=(time.perf_counter() - t0) / 3 * 1e3)
    out["external_scores"] = row


def stats_binner(v, rows, cols):
    """The data's 20,000-bin grid: (v + 20) * 500, truncated."""
    return (v + 20.0) * 500.0


def stats_moments(x, truth, launches, kernels, out):
    """meanvar and cov ('high') of the data against f64 on the card within
    REL of the norms; histograms of the labels (1024 bins) and of the data
    through a binner (20,000 bins, 128 columns) equal to np.bincount."""
    import numpy as np
    import torch

    from raft_tpu_torch import stats as tstats
    from raft_tpu_torch.util import precision as tprec

    def run():
        mu, var = tstats.meanvar(x)
        with tprec.scope("high"):
            cov = tstats.cov(x)
        return (mu, var, cov, tstats.histogram(truth, STATS_K),
                tstats.histogram(x, STATS_HIST_BINS, binner=stats_binner))

    (mu, var, cov, h_lab, h_x), wall = stats_part(kernels, launches,
                                                  "moments", run)
    x64 = x.double()
    mu64 = x64.mean(0)
    scale = x64.abs().mean(0)
    x64 -= mu64
    var64 = (x64 * x64).sum(0) / (STATS_M - 1)
    cov64 = x64.T @ x64 / (STATS_M - 1)
    x64.abs_()
    mass = x64.T @ x64 / (STATS_M - 1)
    del x64
    err_mu = float(((mu.double() - mu64).abs() / scale).max())
    err_var = float(((var.double() - var64).abs() / var64).max())
    err_cov = float(((cov.double() - cov64).abs() / mass).max())
    check(err_mu <= REL, f"meanvar: mean off by {err_mu} of mean |x|")
    check(err_var <= REL, f"meanvar: variance off by {err_var}")
    check(err_cov <= REL, f"cov 'high': off by {err_cov} of |xc|'|xc|")
    check(np.array_equal(h_lab.cpu().numpy()[:, 0],
                         np.bincount(truth.cpu().numpy(),
                                     minlength=STATS_K)),
          "histogram of the labels != np.bincount")
    xh = x.cpu().numpy()
    bins = ((xh + np.float32(20.0)) * np.float32(500.0)).astype(np.int64)
    keep = (bins >= 0) & (bins < STATS_HIST_BINS)
    bins *= STATS_D
    bins += np.arange(STATS_D)[None, :]
    want = np.bincount(bins[keep], minlength=STATS_HIST_BINS * STATS_D)
    check(np.array_equal(h_x.cpu().numpy().ravel(), want),
          "histogram with a binner != np.bincount")
    del xh, bins, keep
    out["moments"] = dict(seconds=wall, mean_err_over_mean_abs=err_mu,
                          var_rel_err=err_var, cov_err_over_mass=err_cov,
                          hist_bins=[STATS_K, STATS_HIST_BINS],
                          hist_counted=int(want.sum()))


def silhouette_f64(s, lab, k, chunk=4096):
    """The silhouette in f64 from torch ops: chunked f64 distances and
    index_add_ cluster sums."""
    import torch

    s64 = s.double()
    n = s64.shape[0]
    sq = (s64 * s64).sum(1)
    counts = torch.bincount(lab, minlength=k).double()
    total = 0.0
    for i in range(0, n, chunk):
        sb = s64[i:i + chunk]
        d = (sq[i:i + chunk, None] + sq[None, :] - 2.0 * sb @ s64.T
             ).clamp_min_(0.0)
        sums = torch.zeros(sb.shape[0], k, dtype=torch.float64,
                           device=s.device).index_add_(1, lab, d)
        del d
        lb = lab[i:i + chunk]
        own = counts[lb]
        at = torch.arange(sb.shape[0], device=s.device)
        a = sums[at, lb] / (own - 1).clamp_min(1)
        other = sums / counts.clamp_min(1)[None, :]
        other[at, lb] = float("inf")
        other[:, counts == 0] = float("inf")
        b = other.min(1).values
        sil = torch.where(own > 1, (b - a) / torch.maximum(a, b), 0.0)
        total += float(sil.sum())
    return total / n


def trust_f64(s, emb, k, batch):
    """Trustworthiness in f64 from torch ops: f64 distances, the k
    nearest by a stable sort, ranks by strict comparison."""
    import torch

    s64, e64 = s.double(), emb.double()
    n = s64.shape[0]
    sq, esq = (s64 * s64).sum(1), (e64 * e64).sum(1)
    pen = 0.0
    for i in range(0, n, batch):
        rows = torch.arange(min(batch, n - i), device=s.device)
        de = (esq[i:i + batch, None] + esq[None, :]
              - 2.0 * e64[i:i + batch] @ e64.T).clamp_min_(0.0)
        de[rows, i + rows] = float("inf")
        nn = torch.sort(de, dim=1, stable=True).indices[:, :k]
        do = (sq[i:i + batch, None] + sq[None, :]
              - 2.0 * s64[i:i + batch] @ s64.T).clamp_min_(0.0)
        self_d = do[rows, i + rows]
        dnn = torch.gather(do, 1, nn)
        rank = ((do[:, None, :] < dnn[:, :, None]).sum(2)
                - (self_d[:, None] < dnn).long() + 1)
        pen += float((rank - k).clamp_min(0).sum())
    return 1.0 - pen * 2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0))


def stats_kernel_parity(res, s, lab, emb):
    """The sample scores' kernels at the shapes those calls give them,
    each against its plain version on the card: one silhouette chunk's
    distances (unexpanded_tile l2un, 4096 x 65,536 x 128) and its keyed
    column sums (csr_spmm, 1024 keys over 65,536 columns, against the
    plain CSR product and an f64 index_add_ sum), one trustworthiness
    block's distances in both spaces (L2SqrtUnexpanded, 512 x 65,536 at
    128 and 16 dims) and its top 10 by select_k WARPSORT_FILTERED
    (topk_insert, exactly the stable key sort, and the kernel bit for bit
    its plain version). Returns the numbers by kernel."""
    import importlib

    import torch

    from raft_tpu_torch.distance import DistanceType, pairwise_distance
    from raft_tpu_torch.linalg import contractions as tc
    from raft_tpu_torch.linalg import reduce_cols_by_key
    from raft_tpu_torch.matrix import SelectAlgo, _topk_order, select_k
    from raft_tpu_torch.matrix import topk_insert as tti
    from raft_tpu_torch.sparse import grid_spmv as tg

    red = importlib.import_module("raft_tpu_torch.linalg.reduce")
    n = s.shape[0]

    def distances(x, y, metric, what):
        got = pairwise_distance(res, x, y, metric=metric)
        ref = lambda: UNEXP_DISTANCES[metric.name][1](
            tc.unexpanded_ref(x, y, "l2un"), x.shape[1])
        want = ref()
        e = (got - want).abs()
        check(bool((e <= unexp_rel(x.shape[1]) * want.abs() + 1e-6).all()),
              f"{what}: unexpanded_tile against plain, max err "
              f"{float(e.max())}")
        shape = [x.shape[0], n, x.shape[1]]
        return got, dict(
            shape=shape, metric=metric.name, max_abs_err=float(e.max()),
            bitwise_to_plain=torch.equal(got, want),
            ms=cuda_ms(lambda: pairwise_distance(res, x, y, metric=metric),
                       3),
            plain_ms=cuda_ms(ref, 1),
            bound_ms=unexp_bound(*shape, UNEXP_INSTR["l2un"])[0])

    out = {}
    d0, out["silhouette_distances"] = distances(
        s[:4096], s, DistanceType.L2Unexpanded, "silhouette chunk")
    sums = reduce_cols_by_key(res, d0, lab, STATS_K)
    b = d0.T.contiguous()
    del d0
    ind = red._key_csr(lab, torch.ones_like(lab, dtype=torch.bool), STATS_K,
                       torch.float32)
    want = tg._spmm_plain(*ind, b, STATS_K)
    spmm_err = check_csr_product(sums.T.contiguous(), want, *ind, b,
                                 "silhouette keyed sums")
    # the f64 sum is grouped by index_add_, not through the CSR; the
    # distances are >= 0, so the sum is its own mass
    f64 = torch.zeros(STATS_K, b.shape[1], dtype=torch.float64,
                      device=b.device).index_add_(0, lab, b.double())
    e64 = float((sums.T.double() - f64).abs().max())
    check(bool(((sums.T.double() - f64).abs()
                <= SPARSE_REL * f64 + SPARSE_REL).all()),
          f"silhouette keyed sums against the f64 sum: {e64}")
    out["silhouette_keyed_sums"] = dict(
        shape=[STATS_K, n, b.shape[1]], max_abs_err=spmm_err,
        f64_max_abs_err=e64,
        ms=cuda_ms(lambda: tg._spmm(*ind, b, STATS_K), 5),
        plain_ms=cuda_ms(lambda: tg._spmm_plain(*ind, b, STATS_K), 1),
        bound_ms=spmv_bound(n, STATS_K, n, b.shape[1], 8)[0])
    del sums, b, want, f64
    rows = torch.arange(STATS_BATCH, device=s.device)
    de, out["trust_embedded_distances"] = distances(
        emb[:STATS_BATCH], emb, DistanceType.L2SqrtUnexpanded,
        "trustworthiness embedded block")
    do, out["trust_original_distances"] = distances(
        s[:STATS_BATCH], s, DistanceType.L2SqrtUnexpanded,
        "trustworthiness original block")
    del do
    de[rows, rows] = float("inf")
    vals, idx = select_k(res, de, STATS_NN, select_min=True,
                         algo=SelectAlgo.WARPSORT_FILTERED)
    wv, wi = _topk_order.topk(de, STATS_NN, largest=False)
    check(torch.equal(idx.long(), wi) and torch.equal(vals, wv),
          "trustworthiness block's select_k differs from the stable key "
          "sort")
    exact_equal(tti._topk_insert(de, STATS_NN, True),
                tti._insert_plain(de, STATS_NN, True),
                "topk_insert at the trustworthiness block")
    out["trust_topk"] = dict(
        shape=list(de.shape), k=STATS_NN, max_abs_err=0.0,
        ms=cuda_ms(lambda: tti._topk_insert(de, STATS_NN, True), 5),
        plain_ms=cuda_ms(lambda: tti._insert_plain(de, STATS_NN, True), 3),
        library_ms=cuda_ms(lambda: torch.topk(de, STATS_NN, largest=False),
                           5),
        bound_ms=(4 * de.numel() + 8 * STATS_BATCH * STATS_NN)
        / PEAK_BYTES * 1e3)
    return out


def stats_sample_scores(res, x, fit, launches, kernels, out):
    """On a 65,536-row sample_rows sample with its fit labels: the
    silhouette (n_clusters 1024, 'high') against f64 within
    STATS_SIL_TOL, its time split into distances and keyed sums; the
    trustworthiness of a 16-component PCA embedding (n_neighbors 10,
    batch 512) against f64 within STATS_TRUST_TOL; their kernels against
    their plain versions at these shapes (stats_kernel_parity);
    neighborhood_recall of knn at 'default' against knn at
    'highest' (k = 10, with distances) against a host set computation."""
    import numpy as np

    from raft_tpu_torch import linalg as tlin
    from raft_tpu_torch import stats as tstats
    from raft_tpu_torch.distance import DistanceType, pairwise_distance
    from raft_tpu_torch.matrix import sample_rows
    from raft_tpu_torch.neighbors import knn
    from raft_tpu_torch.random import RngState
    from raft_tpu_torch.util import precision as tprec

    def sample():
        # two draws from equal states pick the same rows
        s = sample_rows(res, RngState(SEED + 41), x, STATS_SAMPLE)
        lab = sample_rows(res, RngState(SEED + 41), fit[:, None],
                          STATS_SAMPLE)[:, 0]
        return s, lab

    (s, lab), _ = stats_part(kernels, launches, "sample", sample)
    check(tuple(s.shape) == (STATS_SAMPLE, STATS_D), "sample_rows: shape")
    with tprec.scope("high"):
        sil, sil_wall = stats_part(
            kernels, launches, "silhouette",
            lambda: float(tstats.silhouette_score(res, s, lab, STATS_K)))
        for name in ("unexpanded_tile", "csr_spmm"):
            check(launches["silhouette"].get(name, 0) > 0,
                  f"silhouette never launched {name}")
        sil64 = silhouette_f64(s, lab, STATS_K)
        check(abs(sil - sil64) <= STATS_SIL_TOL,
              f"silhouette {sil} against f64 {sil64}")
        chunks = [s[i:i + 4096] for i in range(0, STATS_SAMPLE, 4096)]
        metric = DistanceType.L2Unexpanded
        sil_ms = cuda_ms(lambda: tstats.silhouette_score(res, s, lab,
                                                         STATS_K), 1)
        dist_ms = cuda_ms(lambda: [pairwise_distance(res, c, s,
                                                     metric=metric)
                                   for c in chunks], 1)
        d0 = pairwise_distance(res, chunks[0], s, metric=metric)
        keyed_ms = cuda_ms(lambda: tlin.reduce_cols_by_key(
            res, d0, lab, STATS_K), 3)
        del d0
        (emb, _), pca_wall = stats_part(
            kernels, launches, "pca",
            lambda: tlin.pca_fit_transform(res, s, STATS_EMB))
        tw, tw_wall = stats_part(
            kernels, launches, "trustworthiness",
            lambda: float(tstats.trustworthiness_score(
                res, s, emb, STATS_NN, batch_size=STATS_BATCH)))
        check(launches["trustworthiness"].get("unexpanded_tile", 0) > 0,
              "trustworthiness never launched unexpanded_tile")
        tw64 = trust_f64(s, emb, STATS_NN, STATS_BATCH)
        check(abs(tw - tw64) <= STATS_TRUST_TOL,
              f"trustworthiness {tw} against f64 {tw64}")
        parity = stats_kernel_parity(res, s, lab, emb)
        # where each call's device time goes (a trace of one call)
        sil_trace = ivf_breakdown(lambda: tstats.silhouette_score(
            res, s, lab, STATS_K), reps=1, top=10)
        tw_trace = ivf_breakdown(lambda: tstats.trustworthiness_score(
            res, s, emb, STATS_NN, batch_size=STATS_BATCH), reps=1, top=10)

    def recall():
        with tprec.scope("default"):
            dd, idd = knn(res, s, s, STATS_NN)
        with tprec.scope("highest"):
            dh, idh = knn(res, s, s, STATS_NN)
        return dd, idd, dh, idh, float(tstats.neighborhood_recall(
            idd, idh, dd, dh))

    (dd, idd, dh, idh, rec), rec_wall = stats_part(kernels, launches,
                                                   "recall", recall)
    i1, i2 = idd.cpu().numpy(), idh.cpu().numpy()
    d1, d2 = dd.cpu().numpy(), dh.cpu().numpy()
    hits = ((i1[:, :, None] == i2[:, None, :])
            | (np.abs(d1[:, :, None] - d2[:, None, :]) <= 1e-4)).any(2)
    rec_host = float(hits.sum()) / hits.size
    check(rec == rec_host, f"neighborhood_recall {rec} != host {rec_host}")
    out["sample"] = dict(
        rows=STATS_SAMPLE,
        silhouette=dict(value=sil, f64=sil64, ms=sil_ms, wall_s=sil_wall,
                        distances_ms=dist_ms,
                        keyed_sums_ms=keyed_ms * len(chunks),
                        keyed_sum_chunk_ms=keyed_ms,
                        trace=sil_trace,
                        distances_bound_ms=unexp_bound(
                            STATS_SAMPLE, STATS_SAMPLE, STATS_D,
                            UNEXP_INSTR["l2un"])[0]),
        trustworthiness=dict(value=tw, f64=tw64, wall_s=tw_wall,
                             trace=tw_trace,
                             pca_s=pca_wall, n_components=STATS_EMB,
                             distances_bound_ms=unexp_bound(
                                 STATS_SAMPLE, STATS_SAMPLE,
                                 STATS_D + STATS_EMB,
                                 UNEXP_INSTR["l2un"])[0]),
        recall=dict(value=rec, host=rec_host, k=STATS_NN, wall_s=rec_wall),
        kernel_parity=parity)
    return parity


def merge_expected(a, b, mask):
    """Each point's smallest label in its component of the graph on the
    labels whose edges are the masked pairs (scipy)."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    nl = int(max(a.max(), b.max())) + 1
    g = sp.coo_matrix((np.ones(int(mask.sum())), (a[mask], b[mask])),
                      shape=(nl, nl))
    _, comp = connected_components(g, directed=False)
    lo = np.full(comp.max() + 1, nl)
    np.minimum.at(lo, comp, np.arange(nl))
    return lo[comp[a]]


def stats_merge(truth, fit, launches, kernels, out):
    """merge_labels of (fit + 1, truth + 1) over all 1M rows, with every
    row masked and with 1% masked, against scipy's components; the
    rounds are the checked call's, from its label.merge_labels event."""
    import numpy as np
    import torch

    from raft_tpu_torch import label as tlabel
    from raft_tpu_torch.core import trace

    a = (fit + 1).to(torch.int32)
    b = (truth + 1).to(torch.int32)
    gen = torch.Generator(device=a.device).manual_seed(SEED + 42)
    masks = {"all": torch.ones(STATS_M, dtype=torch.bool, device=a.device),
             "1%": torch.rand(STATS_M, generator=gen, device=a.device) < 0.01}
    row = {}
    for name, mask in masks.items():
        trace.clear_events()
        got, wall = stats_part(kernels, launches, f"merge_{name}",
                               lambda: tlabel.merge_labels(a, b, mask))
        (event,) = trace.events("label.merge_labels")
        want = merge_expected(a.cpu().numpy(), b.cpu().numpy(),
                              mask.cpu().numpy())
        check(np.array_equal(got.cpu().numpy(), want),
              f"merge_labels ({name} masked) != scipy's components")
        row[name] = dict(seconds=wall, rounds=event["rounds"],
                         components=int(np.unique(want).size))
    out["merge_labels"] = row


def stats_phase(res, dev):
    """Generate data, fit it and score the fit at config 3's shape
    (1,000,000 x 128 f32, 1024 centers), each part with the launch
    counts set to 0 just before it and read just after. Returns the
    phase's launches by kernel and the kernels' numbers at the sample
    scores' shapes (stats_kernel_parity)."""
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.cluster import kmeans as tk
    from raft_tpu_torch.util import precision as tprec

    t0 = time.perf_counter()
    parts, out = {}, {}
    x, truth = stats_generate(res, kernels, parts, out)
    params = tk.KMeansParams(n_clusters=STATS_K, max_iter=MAIN_ITERS,
                             tol=0.0, seed=SEED)

    def fit():
        with tprec.scope("high"):
            return tk.kmeans_fit(res, params, x)

    (_, inertia, fit_lab, n_iter), fit_wall = stats_part(kernels, parts,
                                                         "fit", fit)
    # tol 0: it stops early only where an iteration leaves the inertia
    check(1 <= n_iter <= MAIN_ITERS, f"stats fit: n_iter {n_iter}")
    check(bool(torch.isfinite(inertia)), "stats fit: inertia not finite")
    out["fit"] = dict(seconds=fit_wall, n_iter=n_iter,
                      inertia=float(inertia))
    fit_lab, truth = fit_lab.long(), truth.long()
    stats_external(truth, fit_lab, parts, kernels, out)
    stats_moments(x, truth, parts, kernels, out)
    parity = stats_sample_scores(res, x, fit_lab, parts, kernels, out)
    stats_merge(truth, fit_lab, parts, kernels, out)
    launches = {}
    for counts in parts.values():
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c
    for name in ("unexpanded_tile", "fused_lloyd", "csr_spmm"):
        check(launches.get(name, 0) > 0, f"stats phase never launched {name}")
    out["launches"] = launches
    out["launches_by_part"] = {p: c for p, c in parts.items() if c}
    out["seconds"] = time.perf_counter() - t0
    emit("stats", **out)
    del x
    torch.cuda.empty_cache()
    return launches, parity


def lap_solve(res, cost):
    """One solve of the [B, n, n] batch ``cost``: the problem, the host
    wall ms (ending in a sync) and the call's trace event."""
    import torch

    from raft_tpu_torch.core import trace
    from raft_tpu_torch.solver import LinearAssignmentProblem

    b, n, _ = cost.shape
    lap = LinearAssignmentProblem(res, n, b)
    trace.clear_events()
    t0 = time.perf_counter()
    lap.solve(cost)
    if cost.is_cuda:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    (event,) = trace.events("solver.linear_assignment")
    return lap, ms, event


def lap_numbers(cost, ms, event):
    """ms, rounds, host reads and a round's one read of the benefit
    matrix against HBM's rate."""
    rounds = sum(event["rounds"])
    read = cost.numel() * cost.element_size()
    return dict(shape=list(cost.shape), ms=ms,
                rounds_by_phase=event["rounds"], rounds=rounds,
                syncs=event["syncs"], ms_per_round=ms / rounds,
                round_read_bytes=read,
                round_bound_ms=read / PEAK_BYTES * 1e3)


def lap_dual_f64(lap, lane):
    """The lane's dual objective summed in f64 on the host."""
    return -float(lap._row_duals[lane].double().sum()
                  + lap._col_duals[lane].double().sum())


def lap_same(card, cpu, lanes, what):
    """Assignments and prices of ``card`` (its ``lanes``) bit for bit
    those of ``cpu``."""
    import torch

    for name in ("row_assignments", "col_assignments", "_col_duals",
                 "_row_duals"):
        got = getattr(card, name)[lanes].cpu()
        want = getattr(cpu, name)
        check(torch.equal(got, want), f"{what}: {name} differs from the "
              "CPU run")


def primitives_lap(res, dev, out):
    """(a) one integral 1024 x 1024 problem, exact: scipy's total; (b) 64
    uniform 256 x 256 problems, each within n·eps of its optimum and of
    its dual; (c) one uniform 4096 x 4096 problem. (a) and (b) bit for bit
    the CPU run of the same inputs ((b) on LAP_B_CPU_LANES of its
    lanes)."""
    import numpy as np
    import torch
    from scipy.optimize import linear_sum_assignment

    from raft_tpu_torch import device_resources

    cpu = device_resources("cpu")
    rng = np.random.default_rng(SEED + 16)
    lap_out = {}
    # (a)
    b, n = LAP_A
    host = rng.integers(0, LAP_COST_MAX, (b, n, n)).astype(np.float32)
    cost = torch.from_numpy(host).to(dev)
    card, ms, event = lap_solve(res, cost)
    r, c = linear_sum_assignment(host[0])
    want = float(host[0][r, c].astype(np.float64).sum())
    got = float(card.get_primal_objective_value(0))
    check(got == want, f"LAP (a): total {got} != scipy's {want}")
    t0 = time.perf_counter()
    ref, cpu_ms, cpu_event = lap_solve(cpu, torch.from_numpy(host))
    lap_same(card, ref, slice(None), "LAP (a)")
    lap_out["a"] = dict(lap_numbers(cost, ms, event), total=got,
                        scipy_total=want, cpu_ms=cpu_ms,
                        cpu_rounds_by_phase=cpu_event["rounds"],
                        bitwise_cpu=True)
    # (b)
    b, n = LAP_B
    host = rng.random((b, n, n), dtype=np.float64).astype(np.float32)
    cost = torch.from_numpy(host).to(dev)
    card, ms, event = lap_solve(res, cost)
    eps = card._eps
    gaps = []
    for lane in range(b):
        r, c = linear_sum_assignment(host[lane].astype(np.float64))
        opt = float(host[lane].astype(np.float64)[r, c].sum())
        rows = card.row_assignments[lane].cpu().numpy()
        primal = float(host[lane].astype(np.float64)[np.arange(n), rows]
                       .sum())
        dual = lap_dual_f64(card, lane)
        check(sorted(rows.tolist()) == list(range(n)),
              f"LAP (b) lane {lane}: not a permutation")
        check(primal - opt <= n * eps and abs(primal - dual) <= n * eps,
              f"LAP (b) lane {lane}: primal {primal}, optimum {opt}, dual "
              f"{dual} beyond n·eps {n * eps}")
        gaps.append(primal - opt)
    lanes = slice(0, b, b // LAP_B_CPU_LANES)
    ref, cpu_ms, _ = lap_solve(cpu, torch.from_numpy(host[lanes]))
    lap_same(card, ref, lanes, "LAP (b)")
    lap_out["b"] = dict(lap_numbers(cost, ms, event), n_eps=n * eps,
                        max_primal_minus_optimum=max(gaps),
                        cpu_lanes=LAP_B_CPU_LANES, cpu_ms=cpu_ms,
                        bitwise_cpu=True)
    # (c)
    b, n = LAP_C
    cost = torch.rand((b, n, n), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    card, ms, event = lap_solve(res, cost)
    rows = card.row_assignments[0]
    check(bool((torch.sort(rows).values == torch.arange(
        n, device=dev, dtype=rows.dtype)).all()), "LAP (c): not a "
          "permutation")
    primal = float(torch.gather(cost[0].double(), 1, rows.long()[:, None])
                   .sum())
    gap = primal - lap_dual_f64(card, 0)
    check(abs(gap) <= n * card._eps, f"LAP (c): primal - dual {gap} beyond "
          f"n·eps {n * card._eps}")
    lap_out["c"] = dict(lap_numbers(cost, ms, event), primal_minus_dual=gap)
    out["lap"] = lap_out


def primitives_cache(res, dev, out):
    """cuML SVC's kernel cache at 1024 MiB through the device tier:
    CACHE_STEPS insert and lookup batches of CACHE_BATCH distinct keys,
    half of each drawn from the keys already fed (reuse), on the card and
    on the CPU; hits, vectors and the final state equal."""
    import numpy as np
    import torch

    from raft_tpu_torch import device_resources
    from raft_tpu_torch.util import cache as tcache

    cpu = device_resources("cpu")
    card = tcache.device_cache_init(CACHE_ROWS, CACHE_COLS, CACHE_ASSOC,
                                    res=res)
    host = tcache.device_cache_init(CACHE_ROWS, CACHE_COLS, CACHE_ASSOC,
                                    res=cpu)
    rng = np.random.default_rng(SEED + 17)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    seen = np.zeros(0, np.int64)
    ins_ms, look_ms, hit_rate = [], [], []
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(CACHE_STEPS):
        old = rng.choice(seen, min(seen.size, CACHE_BATCH // 2),
                         replace=False) if seen.size else seen
        fresh = np.setdiff1d(rng.choice(CACHE_KEYS, 2 * CACHE_BATCH,
                                        replace=False), old)
        keys = np.concatenate([old, rng.permutation(fresh)[
            :CACHE_BATCH - old.size]]).astype(np.int32)
        rng.shuffle(keys)
        seen = np.union1d(seen, keys)
        vecs = torch.randn((CACHE_BATCH, CACHE_ROWS), generator=gen,
                           device=dev)
        kd = torch.from_numpy(keys).to(dev)
        start.record()
        tcache.device_cache_insert(card, kd, vecs)
        end.record()
        torch.cuda.synchronize()
        ins_ms.append(start.elapsed_time(end))
        tcache.device_cache_insert(host, torch.from_numpy(keys), vecs.cpu())
        probe = rng.permutation(np.concatenate([
            rng.choice(seen, CACHE_BATCH // 2, replace=False),
            np.setdiff1d(rng.choice(CACHE_KEYS, CACHE_BATCH, replace=False),
                         seen)[:CACHE_BATCH // 2]])).astype(np.int32)
        pd = torch.from_numpy(probe).to(dev)
        start.record()
        got, hit, _ = tcache.device_cache_lookup(card, pd)
        end.record()
        torch.cuda.synchronize()
        look_ms.append(start.elapsed_time(end))
        want, want_hit, _ = tcache.device_cache_lookup(
            host, torch.from_numpy(probe))
        check(torch.equal(hit.cpu(), want_hit), "cache: hits differ")
        check(torch.equal(got.cpu(), want), "cache: vectors differ")
        hit_rate.append(float(hit.float().mean()))
    for name in ("keys", "time", "clock"):
        check(torch.equal(getattr(card, name).cpu(), getattr(host, name)),
              f"cache: final {name} differs")
    check(torch.equal(card.store, host.store.to(dev)),
          "cache: final store differs")
    batch_bytes = 2 * CACHE_BATCH * CACHE_ROWS * 4   # vectors in and out
    out["cache"] = dict(
        store_bytes=card.store.numel() * 4, n_sets=card.n_sets,
        associativity=card.associativity, batch=CACHE_BATCH,
        steps=CACHE_STEPS, hit_rate=hit_rate,
        insert_ms=float(np.mean(ins_ms[1:])),
        lookup_ms=float(np.mean(look_ms[1:])),
        batch_bytes=batch_bytes, bound_ms=batch_bytes / PEAK_BYTES * 1e3,
        equal_cpu=True)
    del card, host


def primitives_host(res, dev, out):
    """A 1M x 128 f32 device matrix: device -> pinned host -> device
    through core.mdarray, bitwise; serialize.dumps/loads of it and of its
    bf16 rounding against np.save of the host copy; native npy_save's
    bytes against dumps; parallel_copy against one np.copyto; the
    handle's memory stats after the allocation."""
    import io

    import numpy as np
    import torch

    from raft_tpu_torch.core import mdarray as tmd
    from raft_tpu_torch.core import native_runtime as tnr
    from raft_tpu_torch.core import resources as tres
    from raft_tpu_torch.core import serialize as tser
    from raft_tpu_torch.core.memory_type import DEVICE

    check(tnr.native_available(), "native runtime: "
          + tnr._native.build_error())
    x = torch.randn((XFER_M, XFER_D), generator=torch.Generator(
        device=dev).manual_seed(SEED + 18), device=dev)
    torch.cuda.synchronize()
    stats = tres.get_memory_stats(res)
    check(stats["bytes_in_use"] == torch.cuda.memory_allocated(dev),
          f"get_memory_stats {stats} != memory_allocated")
    nbytes = x.numel() * 4
    pin = tmd.make_pinned_matrix(XFER_M, XFER_D)
    check(pin.data.is_pinned(), "make_pinned_matrix is not page-locked")
    back = tmd.make_device_matrix(res, XFER_M, XFER_D)
    src = tmd.MdArray(x, DEVICE)
    d2h, h2d = [], []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tmd.copy(res, pin, src)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tmd.copy(res, back, pin)
        torch.cuda.synchronize()
        d2h.append(t1 - t0)
        h2d.append(time.perf_counter() - t1)
    check(pin.data.is_pinned(), "copy replaced the pinned buffer")
    check(torch.equal(back.data, x), "device -> pinned -> device differs")
    host = pin.data.numpy()
    t0 = time.perf_counter()
    blob = tser.dumps(x)
    dumps_s = time.perf_counter() - t0
    buf = io.BytesIO()
    np.save(buf, host, allow_pickle=False)
    check(blob == buf.getvalue(), "dumps != np.save of the host copy")
    t0 = time.perf_counter()
    loaded = tser.loads(blob, res=res)
    torch.cuda.synchronize()
    loads_s = time.perf_counter() - t0
    check(torch.equal(loaded, x), "loads(dumps(x)) differs")
    del loaded
    xb = x.to(torch.bfloat16)
    bbits = xb.view(torch.int16).cpu().numpy().view(np.uint16)
    buf = io.BytesIO()
    np.save(buf, bbits.view([("bfloat16", np.uint16)]), allow_pickle=False)
    bblob = tser.dumps(xb)
    check(bblob == buf.getvalue(), "bf16 dumps != np.save of its wire form")
    check(torch.equal(tser.loads(bblob, res=res).view(torch.int16),
                      xb.view(torch.int16)), "bf16 loads differs")
    del xb
    tmp = Path("build") / "primitives"
    tmp.mkdir(parents=True, exist_ok=True)
    path = tmp / "x.npy"
    try:
        t0 = time.perf_counter()
        tnr.npy_save(str(path), x)
        npy_save_s = time.perf_counter() - t0
        check(path.read_bytes() == blob, "native npy_save != dumps")
        check(np.array_equal(tnr.npy_load(str(path)), host),
              "native npy_load differs")
    finally:
        path.unlink(missing_ok=True)
    del blob
    dst, dst1 = np.empty_like(host), np.empty_like(host)
    pool = tnr.NativeThreadPool()
    pool.parallel_copy(dst, host)
    t0 = time.perf_counter()
    pool.parallel_copy(dst, host)
    par_s = time.perf_counter() - t0
    pool.close()
    np.copyto(dst1, host)
    t0 = time.perf_counter()
    np.copyto(dst1, host)
    one_s = time.perf_counter() - t0
    check(np.array_equal(dst, host) and np.array_equal(dst1, host),
          "parallel_copy differs")
    d2h_s, h2d_s = min(d2h), min(h2d)
    out["host"] = dict(
        shape=[XFER_M, XFER_D], bytes=nbytes, memory_stats=stats,
        d2h_pinned_ms=d2h_s * 1e3, d2h_gb_s=nbytes / d2h_s / 1e9,
        h2d_pinned_ms=h2d_s * 1e3, h2d_gb_s=nbytes / h2d_s / 1e9,
        pcie5_x16_gb_s=PCIE5_X16_BYTES / 1e9,
        dumps_ms=dumps_s * 1e3, loads_ms=loads_s * 1e3,
        npy_save_ms=npy_save_s * 1e3, native_available=True,
        parallel_copy_ms=par_s * 1e3, np_copyto_ms=one_s * 1e3,
        copy_threads=os.cpu_count(), bitwise=True)
    del x, back, pin
    torch.cuda.empty_cache()


def primitives_handle(res, dev, out):
    """runtime_arch, the capability figures, matmul_escalation of a gemm
    at 'default' (the 'high' bits), and DeviceResourcesSNMG over the one
    card with its comms self-tests (a NCCL world of size 1, destroyed
    after)."""
    import torch
    import torch.distributed as dist

    from raft_tpu_torch.comms import test_suite
    from raft_tpu_torch.core import resources as tres
    from raft_tpu_torch.linalg import gemm
    from raft_tpu_torch.util import arch, numerics

    a = arch.runtime_arch()
    check(a.gen == 90, f"runtime_arch().gen {a.gen} != 90")
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    x = torch.randn((4096, 1024), generator=gen, device=dev)
    y = torch.randn((1024, 2048), generator=gen, device=dev)
    with numerics.tier_scope("default"):
        low = gemm(res, x, y)
        up = numerics.matmul_escalation(lambda: gemm(res, x, y))()
    with numerics.tier_scope("high"):
        high = gemm(res, x, y)
    check(torch.equal(up, high) and not torch.equal(low, high),
          "matmul_escalation at 'default' does not give 'high''s bits")
    check(not dist.is_initialized(), "a process group is already up")
    try:
        snmg = tres.DeviceResourcesSNMG(devices=[dev])
        check(snmg.n_ranks == 1, f"SNMG n_ranks {snmg.n_ranks}")
        comms = tres.get_comms(snmg)
        tests = {name: bool(getattr(test_suite, name)(comms))
                 for name in ("perform_test_comms_allreduce",
                              "perform_test_comms_bcast",
                              "perform_test_comms_allgather",
                              "perform_test_comms_reducescatter")}
        check(all(tests.values()), f"SNMG comms self-tests {tests}")
    finally:
        dist.destroy_process_group()
    out["handle"] = dict(
        arch=dict(kind=a.device_kind, gen=a.gen,
                  vmem_bytes=arch.vmem_bytes(), mxu_dim=arch.mxu_dim(),
                  vreg_shape=list(arch.vreg_shape())),
        escalation_equal_high=True, snmg_ranks=1, snmg_self_tests=tests)


def primitives_phase(res, dev):
    """The host core, the handle, the util layer, the device cache and
    the LAP solver through their entry points (the ``primitives`` line).
    No kernel of the registry runs here: the counts are set to 0 before
    and must read 0 after."""
    import torch

    from raft_tpu_torch import kernels

    t0 = time.perf_counter()
    torch.empty(0, device=dev)      # the allocator is up, run alone too
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    kernels.reset_launch_counts()
    out = {}
    parts = {}
    for name, fn in (("lap", primitives_lap), ("cache", primitives_cache),
                     ("host", primitives_host),
                     ("handle", primitives_handle)):
        t1 = time.perf_counter()
        fn(res, dev, out)
        parts[name] = time.perf_counter() - t1
    launches = {n: c for n, c in kernels.launch_counts().items() if c}
    check(not launches, f"primitives launched registry kernels {launches}")
    out["launches"] = launches
    out["part_seconds"] = parts
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
    out["seconds"] = time.perf_counter() - t0
    out["reduced"] = [f"LAP (b): the CPU re-run covers {LAP_B_CPU_LANES} "
                      f"of its {LAP_B[0]} lanes (one in "
                      f"{LAP_B[0] // LAP_B_CPU_LANES}; lanes never share "
                      "state), for the phase's time"]
    emit("primitives", **out)


# ---------------------------------------------------------------------------
# the sparse_compat phase: weak_cc, the CSR select_k, ELL, SDDMM and the
# pylibraft-shaped compat layer at full size
# ---------------------------------------------------------------------------


def weak_cc_truth(a):
    """scipy's weak components of the scipy matrix ``a``, each labelled
    1 + its smallest vertex (the reference's labels), as an int32 numpy
    array."""
    import numpy as np
    from scipy.sparse.csgraph import connected_components

    _, comp = connected_components(a, directed=True,
                                   connection="weak")
    first = np.full(comp.max() + 1, comp.shape[0], np.int64)
    np.minimum.at(first, comp, np.arange(comp.shape[0]))
    return (first[comp] + 1).astype(np.int32)


def sc_weak_cc(res, dev, g, out):
    """weak_cc on config 4's graph against scipy, its rounds and ms; a
    masked run against scipy on the kept subgraph and against the CPU
    route; weak_cc_mnmg on a NCCL group of world size 1 bitwise
    weak_cc. No registry kernel runs here."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from raft_tpu_torch import device_resources
    from raft_tpu_torch.comms import bootstrap
    from raft_tpu_torch.core import trace
    from raft_tpu_torch.sparse import csr as tcsr

    n = g.n_rows
    a = g.to_scipy()
    t0 = time.perf_counter()
    truth = weak_cc_truth(a)
    scipy_s = time.perf_counter() - t0
    trace.clear_events()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels = tcsr.weak_cc(res, g)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    ev = trace.events("sparse.weak_cc")[-1]
    check(labels.dtype == torch.int32 and bool(torch.equal(
        labels.cpu(), torch.from_numpy(truth))),
        "weak_cc labels differ from scipy's components")
    ms = cuda_ms(lambda: tcsr.weak_cc(res, g), 3)
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    mask = torch.rand(n, generator=gen, device=dev) >= WCC_MASKED
    masked = tcsr.weak_cc(res, g, mask=mask)
    ev_m = trace.events("sparse.weak_cc")[-1]
    keep = np.nonzero(mask.cpu().numpy())[0]
    sub = weak_cc_truth(a[keep][:, keep])
    check(np.array_equal(masked.cpu().numpy()[keep], keep[sub - 1] + 1),
          "masked weak_cc differs from scipy's components of the kept "
          "subgraph")
    t0 = time.perf_counter()
    cpu = tcsr.weak_cc(device_resources("cpu"), g.to_host(),
                       mask=mask.cpu())
    cpu_s = time.perf_counter() - t0
    check(torch.equal(masked.cpu(), cpu), "masked weak_cc differs from "
          "the CPU route")
    check(bool((masked[~mask] == 2 ** 31 - 1).all()),
          "a masked vertex took a label")
    torch.cuda.set_device(0)
    bootstrap.initialize_distributed(num_processes=1, process_id=0,
                                     backend="nccl")
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        mn = tcsr.weak_cc_mnmg(res, g, mesh)
        mn_masked = tcsr.weak_cc_mnmg(res, g, mesh, mask=mask)
        mn_ms = cuda_ms(lambda: tcsr.weak_cc_mnmg(res, g, mesh), 3)
    finally:
        dist.destroy_process_group()
    check(torch.equal(mn, labels) and torch.equal(mn_masked, masked),
          "weak_cc_mnmg at world size 1 differs from weak_cc")
    out["weak_cc"] = dict(
        vertices=n, entries=g.logical_nnz(),
        components=int(len(np.unique(truth))),
        equal_scipy=True, scipy_s=scipy_s, rounds=ev["rounds"],
        first_call_s=first_s, ms=ms,
        masked=dict(fraction=WCC_MASKED, rounds=ev_m["rounds"],
                    equal_scipy=True, equal_cpu=True, cpu_s=cpu_s),
        mnmg=dict(backend="nccl", world_size=1, bitwise_weak_cc=True,
                  ms=mn_ms))


def sc_select_csr(dev):
    """A CSR of SC_ROWS rows of 0..SC_MAX_LEN entries (row 0 the longest)
    and its rows as a padded tile, from the seed."""
    import torch

    from raft_tpu_torch.core.sparse_types import CSRMatrix

    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    lens = torch.randint(0, SC_MAX_LEN + 1, (SC_ROWS,), generator=gen,
                         device=dev)
    lens[0] = SC_MAX_LEN
    vals = torch.randn(SC_ROWS, SC_MAX_LEN, generator=gen, device=dev)
    cols = torch.randint(0, SC_COLS, (SC_ROWS, SC_MAX_LEN), generator=gen,
                         device=dev, dtype=torch.int32)
    live = torch.arange(SC_MAX_LEN, device=dev)[None, :] < lens[:, None]
    indptr = torch.zeros(SC_ROWS + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(lens, 0)
    csr = CSRMatrix(indptr, cols[live], vals[live], (SC_ROWS, SC_COLS))
    return csr, vals, cols, live, lens


def sc_select_k(res, dev, out):
    """The CSR select_k at k = SC_K, min and max, by the radix and the
    insertion kernels (and AUTO, which takes torch's top-k at this
    width): bit for bit the dense select_k over the same padded rows.
    Returns the launches of the counted calls."""
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.matrix.select_k import SelectAlgo, select_k
    from raft_tpu_torch.sparse import matrix as smat

    csr, vals, cols, live, lens = sc_select_csr(dev)
    nnz = csr.logical_nnz()
    counted = {}
    parts = {}
    for algo, must in ((SelectAlgo.RADIX_11BITS,
                        ("radix_threshold", "radix_emit")),
                       (SelectAlgo.WARPSORT_FILTERED, ("topk_insert",)),
                       (SelectAlgo.AUTO, ())):
        for select_min in (True, False):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            got_v, got_i = smat.select_k(res, csr, SC_K, select_min,
                                         algo=algo)
            torch.cuda.synchronize()
            launches = {k: v for k, v in kernels.launch_counts().items()
                        if v}
            for name in must:
                check(launches.get(name, 0) > 0,
                      f"sparse select_k {algo.name} never launched {name}")
            for name, c in launches.items():
                counted[name] = counted.get(name, 0) + c
            pad = float("inf") if select_min else float("-inf")
            tile = torch.where(live, vals, torch.full_like(vals, pad))
            want_v, pos = select_k(res, tile, SC_K, select_min, algo=algo)
            pos = pos.long()
            want_i = torch.where(pos < lens[:, None], cols.gather(1, pos),
                                 torch.full_like(pos, -1).to(cols.dtype))
            check(torch.equal(got_v.view(torch.int32),
                              want_v.view(torch.int32))
                  and torch.equal(got_i, want_i),
                  f"sparse select_k {algo.name} min={select_min} differs "
                  "from the dense selection")
            key = f"{algo.name.lower()}_{'min' if select_min else 'max'}"
            parts[key] = dict(
                launches=launches,
                ms=cuda_ms(lambda: smat.select_k(res, csr, SC_K, select_min,
                                                 algo=algo), 5),
                dense_ms=cuda_ms(lambda: select_k(res, tile, SC_K,
                                                  select_min, algo=algo), 5))
            del tile
    bound_bytes = nnz * 8 + (SC_ROWS + 1) * 4 + SC_ROWS * SC_K * 8
    out["select_k"] = dict(
        rows=SC_ROWS, max_row_len=SC_MAX_LEN, entries=nnz, k=SC_K,
        padded_tile_bytes=SC_ROWS * SC_MAX_LEN * 4, bitwise_dense=True,
        bound_ms=bound_bytes / PEAK_BYTES * 1e3, bound_bytes=bound_bytes,
        calls=parts)
    return counted


def sc_uniform_csr(dev):
    """ELL_ROWS x ELL_ROWS, ELL_WIDTH distinct random columns a row."""
    import torch

    from raft_tpu_torch.core.sparse_types import CSRMatrix

    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    cols = torch.argsort(torch.rand(ELL_ROWS, ELL_ROWS // 64, generator=gen,
                                    device=dev), dim=1)[:, :ELL_WIDTH]
    cols = torch.sort(cols * 64 + torch.randint(
        0, 64, cols.shape, generator=gen, device=dev), dim=1).values
    data = torch.randn(ELL_ROWS * ELL_WIDTH, generator=gen, device=dev)
    indptr = torch.arange(ELL_ROWS + 1, dtype=torch.int32,
                          device=dev) * ELL_WIDTH
    return CSRMatrix(indptr, cols.reshape(-1).to(torch.int32), data,
                     (ELL_ROWS, ELL_ROWS))


def sc_ell(res, dev, csr, out):
    """ELL spmv and spmm (k = SPMM_K) against csr_spmv.cu and csr_spmm.cu
    on the same uniform-width CSR, within the sparse tolerance; both
    timed. The CSR calls are comparisons and are not counted."""
    import torch

    from raft_tpu_torch.sparse import ell, linalg

    e = ell.from_csr(csr)
    check(e.width == ELL_WIDTH and e.padding_ratio == 1.0,
          f"ELL width {e.width}, padding {e.padding_ratio}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    x = torch.randn(ELL_ROWS, generator=gen, device=dev)
    b = torch.randn(ELL_ROWS, SPMM_K, generator=gen, device=dev)
    err_v = check_csr_product(linalg.spmv(e, x), linalg.spmv(csr, x),
                              csr.indptr, csr.indices, csr.data, x,
                              "ELL spmv against csr_spmv")
    err_m = check_csr_product(linalg.spmm(e, b), linalg.spmm(csr, b),
                              csr.indptr, csr.indices, csr.data, b,
                              "ELL spmm against csr_spmm")
    nnz = csr.logical_nnz()
    out["ell"] = dict(
        rows=ELL_ROWS, width=e.width, entries=nnz,
        from_csr_ms=cuda_ms(lambda: ell.from_csr(csr), 3),
        spmv_ms=cuda_ms(lambda: linalg.spmv(e, x), 20),
        csr_spmv_ms=cuda_ms(lambda: linalg.spmv(csr, x), 20),
        spmm_k16_ms=cuda_ms(lambda: linalg.spmm(e, b), 10),
        csr_spmm_k16_ms=cuda_ms(lambda: linalg.spmm(csr, b), 10),
        spmv_bound_ms=spmv_bound(nnz, ELL_ROWS, ELL_ROWS, 1, 4)[0],
        spmm_bound_ms=spmv_bound(nnz, ELL_ROWS, ELL_ROWS, SPMM_K, 4)[0],
        max_abs_err={"spmv": err_v, "spmm": err_m})


def bitmap_of(csr):
    """The Bitmap of ``csr``'s pattern, packed on the card from the
    entries' positions (no dense bool matrix)."""
    import torch

    from raft_tpu_torch.core.bitset import Bitmap

    rows = csr.row_ids().long()[:csr.logical_nnz()]
    pos = rows * csr.n_cols + csr.indices[:csr.logical_nnz()].long()
    n_words = -(-csr.n_rows * csr.n_cols // 32)
    words = torch.zeros(n_words, dtype=torch.int64, device=pos.device)
    words.index_add_(0, pos // 32, torch.ones_like(pos) << (pos % 32))
    return Bitmap(csr.n_rows, csr.n_cols,
                  (words & 0xFFFFFFFF).to(torch.uint32))


def sc_sddmm(res, dev, csr, out):
    """sddmm and masked_matmul (Bitmap of the same pattern) at
    A [ELL_ROWS x SDDMM_K], B [SDDMM_K x ELL_ROWS] on the uniform-width
    pattern, at each tier: the pattern exactly, values within the tier's
    tolerance of f64 dots on a sample of entries; ms beside the bound."""
    import torch

    from raft_tpu_torch.sparse import linalg
    from raft_tpu_torch.util import precision

    gen = torch.Generator(device=dev).manual_seed(SEED + 44)
    a = torch.randn(ELL_ROWS, SDDMM_K, generator=gen, device=dev)
    b = torch.randn(SDDMM_K, ELL_ROWS, generator=gen, device=dev)
    mask = bitmap_of(csr)
    nnz = csr.logical_nnz()
    rows = csr.row_ids().long()
    cols = csr.indices.long()
    sample = torch.randint(0, nnz, (SDDMM_SAMPLE,), generator=gen,
                           device=dev)
    ar, bc = a[rows[sample]].double(), b.T[cols[sample]].double()
    want = (ar * bc).sum(1)
    mass = (ar.abs() * bc.abs()).sum(1)
    tiers = {}
    for tier in TIERS:
        with precision.scope(tier):
            got = linalg.sddmm(a, b, csr)
            mm = linalg.masked_matmul(a, b.T.contiguous(), mask)
            check(torch.equal(got.indptr.long(), csr.indptr.long())
                  and torch.equal(got.indices, csr.indices)
                  and torch.equal(mm.indptr.long(), csr.indptr.long())
                  and torch.equal(mm.indices, csr.indices),
                  f"sddmm/masked_matmul pattern at {tier}")
            errs = {}
            for name, c in (("sddmm", got), ("masked_matmul", mm)):
                err = (c.data[sample].double() - want).abs()
                rel = float((err / mass).max())
                check(rel <= SDDMM_REL[tier],
                      f"{name} at {tier}: {rel} of |a|.|b|")
                errs[name] = rel
            bt = b.T.contiguous()
            tiers[tier] = dict(
                err_over_mass=errs,
                sddmm_ms=cuda_ms(lambda: linalg.sddmm(a, b, csr), 5),
                masked_matmul_ms=cuda_ms(
                    lambda: linalg.masked_matmul(a, bt, mask), 3))
    # least bytes: A and B once, the pattern's indices and indptr, the
    # values out; the gathers' own traffic (a row of A and a column of B
    # an entry) beside it
    least = (2 * ELL_ROWS * SDDMM_K * 4 + nnz * 4 + (ELL_ROWS + 1) * 4
             + nnz * 4)
    ops_ms = 2 * nnz * SDDMM_K / PEAK_F32_FLOPS * 1e3
    out["sddmm"] = dict(
        a=[ELL_ROWS, SDDMM_K], b=[SDDMM_K, ELL_ROWS], entries=nnz,
        sample=SDDMM_SAMPLE, tolerance=SDDMM_REL, tiers=tiers,
        bound_ms=max(least / PEAK_BYTES * 1e3, ops_ms),
        bound_by="bytes" if least / PEAK_BYTES * 1e3 >= ops_ms
        else "operations",
        gathered_bytes=nnz * 2 * SDDMM_K * 4,
        gathered_ms=nnz * 2 * SDDMM_K * 4 / PEAK_BYTES * 1e3)


def sc_compat(res, dev, g, out):
    """compat.eigsh on config 4's graph bitwise the port's eigsh (the
    csr_spmv launches counted), compat.rmat into an ``out=``
    device_ndarray bitwise rmat_rectangular_gen, device_ndarray's CUDA
    array interface and DLPack without a copy. Returns the launches."""
    import warnings

    import numpy as np
    import torch

    from raft_tpu_torch import compat, kernels
    from raft_tpu_torch.random import RngState, rmat_rectangular_gen
    from raft_tpu_torch.sparse.solver import lanczos

    gen = torch.Generator(device=dev).manual_seed(SEED + 45)
    v0 = torch.randn(g.n_rows, generator=gen, device=dev)
    kw = dict(k=4, which="SA", ncv=20, maxiter=3, tol=1e-7, seed=42)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        w, v = compat.eigsh(g, kw["k"], kw["which"], v0, kw["ncv"],
                            kw["maxiter"], kw["tol"], kw["seed"], res)
        torch.cuda.synchronize()
        eigsh_s = time.perf_counter() - t0
        launches = {k: c for k, c in kernels.launch_counts().items() if c}
        check(launches.get("csr_spmv", 0) > 0,
              "compat.eigsh never launched csr_spmv")
        want_w, want_v = lanczos.eigsh(g, v0=v0, res=res, **kw)
    check(isinstance(w, compat.device_ndarray)
          and torch.equal(w.values, want_w) and torch.equal(v.values, want_v),
          "compat.eigsh differs from eigsh")

    theta = np.tile(np.array([0.57, 0.19, 0.19, 0.05], np.float32),
                    (RMAT_SCALE, 1))
    dst = compat.device_ndarray.empty((RMAT_EDGES, 2), np.int32, res=res)
    ptr = dst.values.data_ptr()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compat.rmat(dst, theta, RMAT_SCALE, RMAT_SCALE, SEED + 46, res)
    rmat_s = time.perf_counter() - t0
    s, d = rmat_rectangular_gen(res, RngState(SEED + 46), RMAT_SCALE,
                                RMAT_SCALE, RMAT_EDGES, theta=theta)
    check(dst.values.data_ptr() == ptr
          and torch.equal(dst.values, torch.stack([s, d], 1)),
          "compat.rmat into out= differs from rmat_rectangular_gen")
    del s, d

    t = torch.arange(1 << 20, dtype=torch.float32, device=dev)
    arr = compat.device_ndarray(t)
    cai = arr.__cuda_array_interface__
    via_cai = torch.as_tensor(arr, device=dev)
    via_dlpack = torch.from_dlpack(arr)
    check(cai["data"][0] == t.data_ptr()
          and via_cai.data_ptr() == t.data_ptr()
          and via_dlpack.data_ptr() == t.data_ptr()
          and tuple(cai["shape"]) == (1 << 20,),
          "device_ndarray did not round-trip without a copy")
    stream = compat.Stream(res)
    stream.sync()
    out["compat"] = dict(
        eigsh=dict(bitwise_eigsh=True, seconds=eigsh_s,
                   values=w.values.tolist(), launches=launches),
        rmat=dict(edges=RMAT_EDGES, scale=RMAT_SCALE, bitwise=True,
                  in_place=True, seconds=rmat_s),
        device_ndarray=dict(cai_same_pointer=True, dlpack_same_pointer=True,
                            typestr=cai["typestr"]),
        stream_on_card=stream.stream is not None)
    return launches


def sparse_compat_phase(res, dev, g, smi):
    """The rest of sparse and the compat layer through their entry points
    (the ``sparse_compat`` line): weak_cc on config 4's graph, the CSR
    select_k, ELL, SDDMM and compat. Returns the launches of the counted
    paths (the CSR select_k and compat.eigsh)."""
    import torch

    t0 = time.perf_counter()
    out = {"nvidia_smi": smi}
    parts = {}
    t1 = time.perf_counter()
    sc_weak_cc(res, dev, g, out)
    parts["weak_cc"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    launches = sc_select_k(res, dev, out)
    parts["select_k"] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    csr = sc_uniform_csr(dev)
    t1 = time.perf_counter()
    sc_ell(res, dev, csr, out)
    parts["ell"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    sc_sddmm(res, dev, csr, out)
    parts["sddmm"] = time.perf_counter() - t1
    del csr
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    for name, c in sc_compat(res, dev, g, out).items():
        launches[name] = launches.get(name, 0) + c
    parts["compat"] = time.perf_counter() - t1
    out["launches"] = launches
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t0
    emit("sparse_compat", **out)
    return launches


# ---------------------------------------------------------------------------
# the guard modes on the card (core/guards.py and the guarded entry points)
# ---------------------------------------------------------------------------

GUARD_SENTINEL_SHAPE = (1 << 20, 1024)  # finite_sentinel's timed tensor
GUARD_A0, GUARD_A1 = 4097.0048828125, 16785450.0   # the Cholesky fixture
PEAK_F64_FLOPS = 34e12   # H100 SXM fp64 outside the tensor cores (data sheet)


def guard_raises(fn, typ, stage=None, op=None, what=""):
    """``fn()`` must raise ``typ`` (with ``stage`` and ``op`` where
    given); returns the message's first words for the record."""
    try:
        fn()
    except typ as e:
        if stage is not None:
            check(e.stage == stage, f"guards {what}: stage {e.stage}, "
                  f"want {stage}")
        if op is not None:
            check(e.op == op, f"guards {what}: op {e.op}, want {op}")
        return str(e)[:80]
    raise AssertionError(f"guards {what}: {typ.__name__} not raised")


def guard_modes(call, ok, nan, big, typ, op, what):
    """One matmul-shaped entry point under each mode: 'off' and a passing
    'check'/'recover' the same bits; a NaN operand raises stage 'input'
    and an overflow from finite operands stage 'output' under both
    modes ('recover' after its re-run one tier up, which overflows too)."""
    import torch

    from raft_tpu_torch.core.guards import guard_scope

    with guard_scope("off"):
        base = call(*ok)
        silent = call(*nan)
    check(not bool(torch.isfinite(silent).all()),
          f"guards {what}: 'off' must let the NaN through")
    out = {"off_nan_propagates": True}
    for mode in ("check", "recover"):
        with guard_scope(mode):
            check(torch.equal(call(*ok), base),
                  f"guards {what}: a passing {mode} changed bits")
            out[f"{mode}_input"] = guard_raises(
                lambda: call(*nan), typ, "input", op, f"{what} {mode} input")
            out[f"{mode}_output"] = guard_raises(
                lambda: call(*big), typ, "output", op,
                f"{what} {mode} output")
    check("top of the ladder" in out["recover_output"]
          or "escalation" in out["recover_output"],
          f"guards {what}: recover did not re-run one tier up")
    out["bitwise_off_check_recover"] = True
    return out


def guards_phase(res, dev):
    """The guard modes on the card (the ``guards`` line): for each guarded
    entry point (pairwise_distance, gemm, spmv, cholesky_r1_update,
    eig_jacobi, kmeans_fit's chunk sentinel) 'off' returns the unguarded
    bits, 'check' raises the reference's typed error with its stage, and
    'recover' returns the escalated result where the reference does (the
    Cholesky pivot and the Jacobi sweep limit at f64); a check inside a
    CUDA graph capture reads nothing; finite_sentinel timed on a
    1M x 1024 f32 tensor beside its bound."""
    import torch

    from raft_tpu_torch.util import precision as tprec

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    out = {"tier": "high"}
    with tprec.scope("high"):
        guards_entry_points(res, dev, gen, out)
    out["seconds"] = time.perf_counter() - t0
    emit("guards", **out)


def guards_entry_points(res, dev, gen, out):
    """The body of :func:`guards_phase`, at tier 'high'."""
    import warnings

    import numpy as np
    import torch

    from raft_tpu_torch.cluster import kmeans as tk
    from raft_tpu_torch.core import guards
    from raft_tpu_torch.core.guards import (IllConditionedError,
                                            NonFiniteError, guard_scope)
    from raft_tpu_torch.distance import DistanceType, pairwise_distance
    from raft_tpu_torch.linalg import eig_jacobi, gemm
    from raft_tpu_torch.linalg.cholesky import cholesky_r1_update
    from raft_tpu_torch.sparse.linalg import spmv

    x = torch.randn(512, 64, generator=gen, device=dev)
    xn = x.clone()
    xn[3, 5] = float("nan")
    xb = torch.full((64, 64), 1e38 / 4, device=dev)
    out["pairwise_distance"] = guard_modes(
        lambda a, b: pairwise_distance(res, a, b,
                                       metric=DistanceType.L2Expanded),
        (x, x[:100]), (xn, x[:100]), (xb, -xb), NonFiniteError,
        "distance.pairwise_distance", "pairwise_distance")
    a = torch.randn(256, 128, generator=gen, device=dev)
    an = a.clone()
    an[0, 0] = float("inf")
    ab = torch.full((64, 64), 2e19, device=dev)
    out["gemm"] = guard_modes(
        lambda p, q: gemm(res, p, q, precision="high"), (a, a.T),
        (an, a.T), (ab, ab), NonFiniteError, "linalg.gemm", "gemm")
    indptr, indices, data = make_csr(gen, dev, 4096, 4096)
    from raft_tpu_torch.core.sparse_types import CSRMatrix

    csr = CSRMatrix(indptr, indices, data, (4096, 4096))
    dn = data.clone()
    dn[1] = float("nan")
    csr_nan = CSRMatrix(indptr, indices, dn, (4096, 4096))
    csr_big = CSRMatrix(indptr, indices, torch.full_like(data, 3e38),
                        (4096, 4096))
    v = torch.ones(4096, device=dev)
    out["spmv"] = guard_modes(lambda m, u: spmv(m, u), (csr, v),
                              (csr_nan, v), (csr_big, v * 4),
                              NonFiniteError, "sparse.linalg.spmv", "spmv")

    # cholesky_r1_update: a non-PSD update (f32 and f64) and an f32
    # cancellation that f64 rescues
    L = torch.zeros((2, 2), device=dev)
    L[0, 0] = 1.0
    bad = torch.tensor([GUARD_A0, GUARD_A1 - 100.0], device=dev)
    rescue = torch.tensor([GUARD_A0, GUARD_A1], device=dev)
    op = "linalg.cholesky_r1_update"
    with guard_scope("off"):
        off = cholesky_r1_update(res, L, bad, 2)
    check(bool(torch.isnan(off[1, 1])), "guards cholesky: off keeps NaN")
    chol = {"off_nan": True}
    for mode in ("check", "recover"):
        with guard_scope(mode):
            chol[f"{mode}_non_psd"] = guard_raises(
                lambda: cholesky_r1_update(res, L, bad, 2),
                IllConditionedError, op=op, what=f"cholesky {mode}")
    with guard_scope("check"):
        chol["check_cancellation"] = guard_raises(
            lambda: cholesky_r1_update(res, L, rescue, 2),
            IllConditionedError, op=op, what="cholesky check")
    with guard_scope("recover"):
        got = cholesky_r1_update(res, L, rescue, 2).cpu().numpy()
    want = np.linalg.cholesky(np.array([[1.0, GUARD_A0],
                                        [GUARD_A0, GUARD_A1]]))
    chol["recover_rel_err_vs_f64"] = float(np.abs(got - want).max()
                                           / np.abs(want).max())
    check(np.allclose(got, want, rtol=1e-5), "guards cholesky: recover "
          f"{got.tolist()} against f64 {want.tolist()}")
    out["cholesky_r1_update"] = chol

    # eig_jacobi: the sweep limit, escalated to the f64 eigh under recover
    s = torch.randn(12, 12, generator=gen, device=dev)
    s = s + s.T
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with guard_scope("check"):
            _, _, rep_c = eig_jacobi(res, s, tol=1e-30, sweeps=1,
                                     return_report=True)
    with guard_scope("recover"):
        w_r, _, rep_r = eig_jacobi(res, s, tol=1e-30, sweeps=1,
                                   return_report=True)
    w64 = np.linalg.eigvalsh(s.double().cpu().numpy())
    eig_err = float(np.abs(w_r.cpu().numpy() - w64).max())
    check(not rep_c.converged and rep_r.escalated and rep_r.converged
          and eig_err <= 1e-5 * float(np.abs(w64).max()),
          f"guards eig_jacobi: recover {rep_r}, err {eig_err}")
    out["eig_jacobi"] = {"check_converged": rep_c.converged,
                         "recover_escalated": rep_r.escalated,
                         "recover_max_abs_err_vs_f64": eig_err}

    # kmeans_fit's chunk sentinel: finite rows whose distances overflow
    xk = torch.randn(4096, 16, generator=gen, device=dev) * 1e19
    p = tk.KMeansParams(n_clusters=8, max_iter=4, tol=0.0,
                        init=tk.KMeansInit.ARRAY)
    with warnings.catch_warnings(), guard_scope("off"):
        warnings.simplefilter("ignore", RuntimeWarning)
        _, inertia_off, _, _ = tk.kmeans_fit(res, p, xk, xk[:8].clone(),
                                             sync_every=2)
    check(not bool(torch.isfinite(inertia_off)),
          "guards kmeans: 'off' must pass the overflow through")
    km = {"off_inertia": float(inertia_off)}
    for mode in ("check", "recover"):
        with guard_scope(mode):
            km[mode] = guard_raises(
                lambda: tk.kmeans_fit(res, p, xk, xk[:8].clone(),
                                      sync_every=2),
                NonFiniteError, op="cluster.kmeans_fit",
                what=f"kmeans sentinel {mode}")
    out["kmeans_fit_sentinel"] = km

    # a check inside a capture reads nothing and passes its output through
    nan = torch.full((8,), float("nan"), device=dev)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), guard_scope("check"):
        graph.capture_begin()
        got = guards.guard_output("guards.captured", nan * 2,
                                  inputs=(nan,))
        graph.capture_end()
    graph.replay()
    torch.cuda.synchronize()
    check(bool(torch.isnan(got).all()), "guards: capture passthrough")
    out["capture_passthrough"] = True
    del graph

    # finite_sentinel's one reduction at 1M x 1024 f32
    big = torch.randn(*GUARD_SENTINEL_SHAPE, generator=gen, device=dev)
    check(bool(guards.finite_sentinel(big)), "finite_sentinel: finite")
    big[-1, -1] = float("inf")
    check(not bool(guards.finite_sentinel(big)), "finite_sentinel: inf")
    nbytes = big.numel() * 4
    ms = cuda_ms(lambda: guards.finite_sentinel(big), 10)
    del big
    torch.cuda.empty_cache()
    out["finite_sentinel"] = {
        "shape": list(GUARD_SENTINEL_SHAPE), "ms": ms,
        "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
        "achieved_gb_s": nbytes / ms / 1e6}


# ---------------------------------------------------------------------------
# config 4: Lanczos chunks, the gated SpMV and the Ritz kernel
# ---------------------------------------------------------------------------

C4_RESTARTS = 16     # outer iterations of the chunked solves (tol 0)
C4_LONG_RESTARTS = 64   # and of the long one, timed only


def ritz_parity(res, g, dev):
    """sym_eig_jacobi at the main path's shape: the projected matrix of
    config 4's first Lanczos extension (ncv 20) and a random symmetric
    ncv x ncv matrix, against the plain version (eigenvalues to 1e-12 of
    the spectrum, vectors to 1e-9), beside the plain version's and
    cuSOLVER's (``torch.linalg.eigh``) times; the bound counts the
    sweeps this input needed."""
    import numpy as np
    import torch

    from raft_tpu_torch.sparse.solver import lanczos as tl

    cfg = tl.LanczosConfig(n_components=4, ncv=20)
    n = g.n_rows
    v = torch.as_tensor(np.random.default_rng(cfg.seed).standard_normal(n),
                        device=dev).to(torch.float32)
    opr = tl._Operator(tl._matvec(g, None, torch.float32, dev), n, 0, n,
                       cfg.seed, dev)
    solve = tl._Solve(opr, cfg, 4, 20, "SA")
    carry, _ = solve.initial(v / torch.linalg.vector_norm(v))
    t = carry[1].contiguous()
    sym = torch.randn(20, 20, dtype=torch.float64, device=dev)
    err = 0.0
    for mat in (t, sym + sym.T):
        got = tl.ritz_eigh(mat)
        want = tl._sym_eig_plain(mat.cpu())
        scale = float(want[0].abs().max())
        ew = float((got[0].cpu() - want[0]).abs().max())
        ev = float((got[1].cpu() - want[1]).abs().max())
        check(ew <= 1e-12 * scale and ev <= 1e-9,
              f"sym_eig_jacobi: eigenvalues {ew}, vectors {ev}")
        err = max(err, ew, ev)
    sweeps = torch.zeros((), dtype=torch.int32, device=dev)
    tl.ritz_eigh(t, sweeps=sweeps)
    n_sw = int(sweeps)
    ms = cuda_ms(lambda: tl.ritz_eigh(t), 50)
    tc = t.cpu()
    tl._sym_eig_plain(tc)
    t0 = time.perf_counter()
    for _ in range(50):
        tl._sym_eig_plain(tc)
    plain_ms = (time.perf_counter() - t0) * 1e3 / 50
    lib_ms = cuda_ms(lambda: torch.linalg.eigh(t), 20)
    m = 20
    # a sweep: m - 1 rounds of m / 2 rotations, each 6 n flops on A's rows,
    # 12 n on A's and V's columns and about 20 for the angle
    flops = n_sw * (m - 1) * (m // 2) * (18 * m + 20) + 4 * m * m
    nbytes = (2 * m * m + m) * 8
    bound = max(nbytes / PEAK_BYTES, flops / PEAK_F64_FLOPS) * 1e3
    from raft_tpu_torch import kernels

    spec = kernels.REGISTRY["sym_eig_jacobi"]
    return {"name": "sym_eig_jacobi", "route": "cuda",
            "source": f"raft_tpu_torch/{spec.source}",
            "replaces": spec.replaces, "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "plain_device": "cpu (torch.linalg.eigh, f64)",
            "bound_ms": bound,
            "bound_by": "bytes" if nbytes / PEAK_BYTES
            >= flops / PEAK_F64_FLOPS else "operations",
            "library_ms": lib_ms,
            "library_call": "torch.linalg.eigh (cuSOLVER syevd, f64; "
                            "reads its info on the host)",
            "parity": "pass", "shape": [m, m], "sweeps": n_sw,
            "tolerance": "eigenvalues 1e-12 of the spectrum, vectors "
                         "1e-9 of the plain version's"}


def gated_spmv_check(g, x):
    """csr_spmv under the driver's gate on config 4's graph: gated on it
    is the ungated kernel bit for bit (and its plain version within the
    sparse band); gated off it writes nothing to y or its partials, and
    costs its launches (timed)."""
    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.sparse import grid_spmv as tg

    n = g.n_rows
    owners = tg._spmv_owners(g.indptr, g.indices.numel())
    free = tg._spmv(g.indptr, g.indices, g.data, x, n, owners)
    on = torch.ones((), dtype=torch.int32, device=x.device)
    off = torch.zeros((), dtype=torch.int32, device=x.device)
    with kernels.gated(on):
        got = tg._spmv(g.indptr, g.indices, g.data, x, n, owners)
    check(torch.equal(got, free), "gated csr_spmv (on) differs from the "
          "ungated kernel")
    err = check_csr_product(got, tg._spmv_plain(g.indptr, g.indices, g.data,
                                                x, n),
                            g.indptr, g.indices, g.data, x,
                            "gated csr_spmv at config 4")
    n_chunks = g.indices.numel() // tg.SPMV_SEG + 1
    y = torch.full((n,), 7.0, device=x.device)
    part = torch.full((n_chunks,), 7.0, device=x.device)
    lanes = tg._spmv_lanes(g.indices.numel(), n)

    def gated_off():
        with kernels.gated(off):
            kernels.launch("csr_spmv", x.device, 0,
                           int(g.indptr.dtype == torch.int64),
                           g.indptr.data_ptr(), g.indices.data_ptr(),
                           g.data.data_ptr(), x.data_ptr(), y.data_ptr(), n,
                           n_chunks, tg.SPMV_SEG, lanes, owners.data_ptr(),
                           part.data_ptr(), kernels.gate_ptr())

    gated_off()
    torch.cuda.synchronize()
    check(bool((y == 7.0).all()) and bool((part == 7.0).all()),
          "gated-off csr_spmv wrote to its outputs")
    off_ms = cuda_ms(gated_off, 50)
    on_ms = cuda_ms(lambda: tg._spmv(g.indptr, g.indices, g.data, x, n,
                                     owners), 20)
    return {"gated_on_bitwise_ungated": True, "gated_on_max_abs_err": err,
            "gated_off_writes_nothing": True, "gated_off_ms": off_ms,
            "gated_on_ms": on_ms}, err


def lanczos_chunks(res, dev, g):
    """eigsh on config 4's graph (k = 4, ncv 20, C4_RESTARTS outer
    iterations, tol 0) at sync_every 1 (the host loop: a host read an
    iteration), at the default on the card and at 8 (captured chunks):
    eigenvalues, vectors and n_iter bit for bit, host reads one a chunk,
    the same launches (replays counted); ms a solve and a restart."""
    import warnings

    import torch

    from raft_tpu_torch.runtime import compiled_driver as cdrv
    from raft_tpu_torch.sparse.solver import lanczos as tl

    cfg = tl.LanczosConfig(n_components=4, ncv=20,
                           max_iterations=C4_RESTARTS, tolerance=0.0)
    default = tl._sync_every(None, g.n_rows, cfg.ncv, g.logical_nnz(), 4,
                             dev)[0]
    out = {"restarts": C4_RESTARTS, "ncv": cfg.ncv, "k": 4,
           "default_sync_every": default, "runs": {}}
    ref = None
    launches_total = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # tol 0: by design
        for sync in (1, default, 8):
            if str(sync) in out["runs"]:
                continue

            def solve(sync=sync):
                return tl.lanczos_compute_eigenpairs(
                    res, g, cfg, return_report=True, sync_every=sync)

            (w, v, rep), launches, gs, wall = cd_run(solve)
            if ref is None:
                ref = (w, v, rep.n_iter, launches)
            check(torch.equal(w, ref[0]) and torch.equal(v, ref[1])
                  and rep.n_iter == ref[2] == C4_RESTARTS,
                  f"config4 eigsh sync_every={sync}: differs from the "
                  "host loop")
            check(launches == ref[3], f"config4 eigsh sync_every={sync}: "
                  f"launches {launches} against {ref[3]}")
            want_reads = -(-(C4_RESTARTS - 1) // sync)
            check(gs["host_reads"] == want_reads,
                  f"config4 eigsh sync_every={sync}: {gs['host_reads']} "
                  f"host reads, want {want_reads}")
            ms = median_ms(solve, 3)
            steps = cfg.ncv + (C4_RESTARTS - 1) * (cfg.ncv - 4)
            out["runs"][str(sync)] = {
                "ms_per_solve": ms, "ms_per_restart": ms / C4_RESTARTS,
                "ms_per_step": ms / steps,
                "first_call_s": wall, "host_reads": gs["host_reads"],
                "captures": gs["captures"], "replays": gs["replays"],
                "steps_launched": gs["steps_launched"]}
            for k_, n_ in launches.items():
                launches_total[k_] = launches_total.get(k_, 0) + n_
    check(launches_total["csr_spmv"] >= 20 + 15 * 16,
          "config4 chunks: csr_spmv never launched")
    # a longer solve, where the capture and the first chunk's masked steps
    # are spread over more replays
    long_cfg = tl.LanczosConfig(n_components=4, ncv=20,
                                max_iterations=C4_LONG_RESTARTS,
                                tolerance=0.0)
    steps = cfg.ncv + (C4_LONG_RESTARTS - 1) * (cfg.ncv - 4)
    out["long"] = {"restarts": C4_LONG_RESTARTS, "steps": steps}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for sync in (1, 8):
            ms = median_ms(lambda sync=sync: tl.lanczos_compute_eigenpairs(
                res, g, long_cfg, sync_every=sync), 3)
            out["long"][str(sync)] = {"ms_per_solve": ms,
                                      "ms_per_step": ms / steps}
    out["eigenvalues"] = ref[0].tolist()
    out["bitwise_across_sync_every"] = True
    out["csr_spmv_launches_per_solve"] = ref[3]["csr_spmv"]
    return out, launches_total


# ---------------------------------------------------------------------------
# config 2: pca_partial_fit's chunks
# ---------------------------------------------------------------------------


def c2_pca_chunks(res, x, out):
    """pca_partial_fit over C2_M x C2_N in C2_CHUNK-row slices at
    sync_every 1 (a host read a slice), at the default and at 4 (captured
    chunks): the state bit for bit; ms each, host reads, captures."""
    import torch

    from raft_tpu_torch import linalg as tl
    from raft_tpu_torch.runtime import compiled_driver as cdrv

    from raft_tpu_torch.runtime import limits

    est = limits.estimate_seconds("linalg.gemm", backend="gpu", m=C2_N,
                                  n=C2_N, k=C2_CHUNK, itemsize=4)
    default = cdrv.resolve_sync_every(None, step_seconds=est,
                                      device=x.device)
    runs, ref = {}, None
    for sync in (1, None, 4, default):
        if str(sync) in runs:
            continue
        st, _, gs, _ = cd_run(lambda sync=sync: tl.pca_partial_fit(
            res, x, chunk_rows=C2_CHUNK, sync_every=sync))
        if ref is None:
            ref = st
        check(all(torch.equal(p, q) for p, q in zip(st, ref)),
              f"config2 pca_partial_fit sync_every={sync}: state differs "
              "from the host loop's")
        runs[str(sync)] = {
            "ms": median_ms(lambda sync=sync: tl.pca_partial_fit(
                res, x, chunk_rows=C2_CHUNK, sync_every=sync), 5),
            "host_reads": gs["host_reads"], "captures": gs["captures"],
            "replays": gs["replays"]}
    out["pca_partial_fit_chunks"] = {
        "shape": [C2_M, C2_N], "chunk_rows": C2_CHUNK,
        "chunks": -(-C2_M // C2_CHUNK), "cost_model_default": default,
        "bitwise_across_sync_every": True, "runs": runs}


# ---------------------------------------------------------------------------
# C5's cost, the operators' dispatch, serving and AOT artifacts
# ---------------------------------------------------------------------------

# the serve phase: the services, their operands and their requests
SERVE_MAX_BATCH, SERVE_WAIT_MS = 256, 2.0
SERVE_TENANTS = {"gold": 4.0, "silver": 2.0, "bronze": 1.0}
SERVE_ROWS = (1, 64)                       # a request's rows, inclusive
SERVE_LOADS = (0.25, 0.5, 0.75, 0.9)       # shares of the measured rate
SERVE_IVF_K, SERVE_IVF_NPROBE = 64, 16
KEPT = {}                                  # operands kept for later phases
# the serve_fleet phase: a replica fleet on the kNN database, and two
# brownout ladders (the kNN k-cap on that database, nprobe on the ivf
# phase's IVF-Flat index)
FLEET_REPLICAS, FLEET_K = 3, 64
FLEET_MAX_BATCH, FLEET_WAIT_MS = 64, 1.0   # buckets 8 .. 64
FLEET_ROWS, FLEET_CLIENTS = 4, 24          # a request's rows; closed-loop
FLEET_PHASE_S = 2.5                        # one load phase
FLEET_KILL = (3.0, 1.0)                    # kill scenarios: run s, kill at
FLEET_SLO_S = 0.1                          # the fleet tenant's SLO latency
FLEET_STALL = (0.05, 0.1, 0.5)             # stall s, duty, period s
FLEET_CHECKED = 500                        # responses held to eager each
BROWN_KS, BROWN_MAX_BATCH = (64, 32, 16), 16   # buckets 8 .. 16
# every brownout tenant's SLO: a launch in flight, the batching wait and
# its own launch (~7 ms each at k = 64) fit; a deeper queue does not
BROWN_SLO_S = 0.025
# the traffic step: a base at this share of the brownout executor's own
# measured closed-loop rate (about one request a launch), then STEP x
# that, which offers the measured rate itself
BROWN_BASE_SHARE, BROWN_STEP = 0.25, 4.0
IVF_LADDER, IVF_LADDER_MAX_BATCH = (16, 8, 4), 12   # buckets 8, 12


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def c5_phase(res, a):
    """C5 on the card: gemm's 'high' on config 2's gram through the dot
    split against the kernels' split it replaced (the two products'
    bits equal on finite operands; times in turns), and the 3 x 3
    probes (an inf, 3.4e38) through gemm, InnerProduct and SDDMM."""
    import numpy as np
    import torch

    from raft_tpu_torch import linalg as tl
    from raft_tpu_torch.distance import DistanceType, pairwise_distance
    from raft_tpu_torch.linalg.blas import _mm_f32
    from raft_tpu_torch.linalg.contractions import _split_hi_lo
    from raft_tpu_torch.sparse import linalg as tsl
    from raft_tpu_torch.util import precision as tprec

    def kernel_split():
        # gemm's 'high' product before C5, the same layout and calls
        hi, lo = _split_hi_lo(a)
        return _mm_f32(hi.T, hi) + _mm_f32(hi.T, lo) + _mm_f32(lo.T, hi)

    def dot_split():
        return tl.gemm(res, a, a, trans_a=True, precision="high")

    with tprec.scope("high"):
        check(torch.equal(dot_split(), kernel_split()),
              "C5: the dot split changed the gram's bits on finite input")
        times = {"kernel_split": [], "dot_split": []}
        for name, fn in (("kernel_split", kernel_split),
                         ("dot_split", dot_split),
                         ("dot_split", dot_split),
                         ("kernel_split", kernel_split)):
            times[name].append(cuda_ms(fn, 10))
    probes = {}
    dev = a.device
    for big in (float("inf"), 3.4e38):
        x = torch.ones(3, 3, device=dev)
        x[0, 0] = big
        y = torch.full((3, 3), 0.5, device=dev)
        with tprec.scope("high"):
            g = tl.gemm(res, x, y)
            ip = pairwise_distance(res, x, y.T.contiguous(),
                                   metric=DistanceType.InnerProduct)
            from raft_tpu_torch.core.sparse_types import CSRMatrix
            import scipy.sparse as sp
            pat = CSRMatrix.from_scipy(sp.csr_matrix(np.ones((3, 4),
                                                             np.float32)),
                                       pad=False, res=res)
            sd = tsl.sddmm(x, torch.full((3, 4), 0.5, device=dev), pat)
        rows = [g[0], ip[0], sd.data[:4]]
        want = float("inf") if big == float("inf") else 1.7e38
        for r in rows:
            check(not bool(torch.isnan(r).any()), f"C5 {big}: NaN on card")
            err = float((r.double() - want).abs().max() / want) \
                if want != float("inf") else float((r != want).sum())
            check(err <= REL, f"C5 {big}: row 0 {r.tolist()}")
        probes[str(big)] = [r.tolist() for r in rows]
    emit("c5", shape=[C2_M, C2_N], tier="high",
         gemm_high_ms=times["dot_split"], kernel_split_ms=times["kernel_split"],
         added_ms=(sum(times["dot_split"]) - sum(times["kernel_split"])) / 2,
         bits_equal_on_finite=True, probes=probes,
         note="gemm 'high' at config 2's gram in turns (kernel split, dot "
              "split, dot split, kernel split); probes: gemm row 0, "
              "InnerProduct row 0, SDDMM row 0 on the card")


def operator_overhead(g, x):
    """csr_spmv at config 4 through ``torch.ops.raft_tpu_torch.csr_spmv``
    against the same launch through ``ctypes`` as the wrapper made it
    before the operators (outputs and partials allocated each call, the
    same plan): device ms a call back to back, and the host's µs to
    issue one call on an empty queue (median of 200)."""
    import statistics

    import torch

    from raft_tpu_torch import kernels
    from raft_tpu_torch.sparse import grid_spmv as tg

    n = g.n_rows
    ip, ix, data = (t.contiguous() for t in (g.indptr, g.indices, g.data))
    owners = tg._spmv_owners(ip, ix.numel())
    n_chunks = ix.numel() // tg.SPMV_SEG + 1
    lanes = tg._spmv_lanes(ix.numel(), n)

    def direct():
        y = torch.empty(n, dtype=x.dtype, device=x.device)
        part = torch.empty(n_chunks, dtype=x.dtype, device=x.device)
        kernels.launch("csr_spmv", x.device, tg._DTYPE_CODE[x.dtype],
                       int(ip.dtype == torch.int64), ip.data_ptr(),
                       ix.data_ptr(), data.data_ptr(), x.data_ptr(),
                       y.data_ptr(), n, n_chunks, tg.SPMV_SEG, lanes,
                       owners.data_ptr(), part.data_ptr(),
                       kernels.gate_ptr())
        return y

    def op():
        return torch.ops.raft_tpu_torch.csr_spmv(ip, ix, data, x, n, owners)

    check(torch.equal(direct(), op()), "operator and direct launch differ")

    def host_us(fn):
        times = []
        for _ in range(200):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        return statistics.median(times)

    out = {"direct": {"ms": [], "host_us": []},
           "operator": {"ms": [], "host_us": []}}
    for name, fn in (("direct", direct), ("operator", op), ("operator", op),
                     ("direct", direct)):
        out[name]["ms"].append(cuda_ms(fn, 50))
        out[name]["host_us"].append(host_us(fn))
    emit("operator_overhead", kernel="csr_spmv", shape=[n, n],
         nnz=g.logical_nnz(), **out,
         added_host_us=(sum(out["operator"]["host_us"])
                        - sum(out["direct"]["host_us"])) / 2,
         added_device_ms=(sum(out["operator"]["ms"])
                          - sum(out["direct"]["ms"])) / 2,
         note="in turns: direct, operator, operator, direct")


def serve_services(res, dev, db):
    """The serve phase's services on their operands: the kNN database,
    config 1's corpus, config 3's centroids, the ivf phase's indexes."""
    from raft_tpu_torch import serve
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.random import RngState, make_blobs

    corpus, _, _ = make_blobs(res, RngState(SEED + 3), PAIRWISE_M,
                              PAIRWISE_K, n_clusters=10)
    svcs = [(serve.KnnService(db, k=64), 256, ("fused_topk",)),
            (serve.KnnService(db, k=1024), 24,
             ("pairwise_tile", "radix_threshold", "radix_emit")),
            (serve.PairwiseService(corpus), 256, ("pairwise_tile",)),
            (serve.PairwiseService(corpus, DistanceType.L1), 64,
             ("unexpanded_tile",)),
            (serve.KMeansPredictService(KEPT["centroids"]), 256,
             ("fused_argmin",))]
    if "ivf_flat" in KEPT:
        svcs.append((serve.IvfKnnService(KEPT["ivf_flat"], SERVE_IVF_K,
                                         SERVE_IVF_NPROBE), 64, ()))
    if "ivf_pq" in KEPT:
        svcs.append((serve.IvfPqKnnService(KEPT["ivf_pq"], SERVE_IVF_K,
                                           SERVE_IVF_NPROBE), 64, ()))
    return svcs


def serve_phase(res, dev, db):
    """The serving executor at full width: three tenants (4 : 2 : 1),
    requests of 1–64 rows drawn from the seed, coalesced into padded
    buckets (8 .. 256) and answered from the drain thread. The requests
    go in once as a burst, which measures the executor's saturation
    rate, then at Poisson arrivals of ``SERVE_LOADS`` shares of that
    rate, latency reported at each; every result bitwise its eager call,
    no build, export or capture after ``warm()``, each service's kernels
    launched. Then each service's exported program against its eager
    callable at every bucket, a deadline probe (1 ms behind a full
    batch) and budget probes (a split, a degrade, a rejection), each
    bitwise or typed as the reference's executor does. Returns the
    launches of the burst and the sweep."""
    import statistics

    import numpy as np
    import torch

    from raft_tpu_torch import kernels, serve
    from raft_tpu_torch.core import trace
    from raft_tpu_torch.runtime import limits
    from raft_tpu_torch.util import precision as tprec

    t_phase = time.perf_counter()
    svcs = serve_services(res, dev, db)
    timing, by_service = {}, {}

    build_s = {}

    class Timed(serve.Executor):
        def _build_executable(self, svc, rows, serving):
            t0 = time.perf_counter()
            exe = super()._build_executable(svc, rows, serving)
            build_s[svc.name] = build_s.get(svc.name, 0.0) + (
                time.perf_counter() - t0)
            return exe

        def _call(self, svc, exe, fixed, q, tier):
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            out = super()._call(svc, exe, fixed, q, tier)
            timing.setdefault(svc.name, {}).setdefault(
                int(q.shape[0]), []).append((time.perf_counter() - t0) * 1e3)
            after = kernels.launch_counts()
            tally = by_service.setdefault(svc.name, {})
            for k_, c in after.items():
                if c - before[k_]:
                    tally[k_] = tally.get(k_, 0) + c - before[k_]
            return out

    qos = serve.QosPolicy({t: serve.TenantPolicy(weight=w)
                           for t, w in SERVE_TENANTS.items()})
    ex = Timed([s for s, _, _ in svcs], policy=serve.BatchPolicy(
        max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_WAIT_MS,
        max_queue=4096), qos=qos)
    trace.clear_events()
    with tprec.scope("high"):
        t0 = time.perf_counter()
        n_exec = ex.warm()
        warm_s = time.perf_counter() - t0
        warm_by = {e["service"]: e["seconds"]
                   for e in trace.events("serve.warmed")}
        fallbacks = {}
        for e in trace.events("serve.aot_fallback"):
            fallbacks[e["service"]] = fallbacks.get(e["service"], 0) + 1
        traces_at_warm = ex.stats.traces
        timing.clear()
        by_service.clear()
        rng = np.random.default_rng(SEED + 40)
        reqs = []
        names = list(SERVE_TENANTS)
        p = np.array(list(SERVE_TENANTS.values()))
        for svc, count, _ in svcs:
            for _ in range(count):
                rows = int(rng.integers(SERVE_ROWS[0], SERVE_ROWS[1] + 1))
                reqs.append((svc, rng.standard_normal(
                    (rows, svc.dim)).astype(np.float32),
                    names[int(rng.choice(3, p=p / p.sum()))]))
        order = rng.permutation(len(reqs))
        gaps = rng.exponential(1.0, len(reqs))   # unit-rate Poisson gaps
        eager = {}
        for i, (svc, q, _) in enumerate(reqs):
            want = svc.eager(q)
            eager[i] = want if isinstance(want, tuple) else (want,)
        sync(dev)

        def run(rate):
            """Submit every request, in ``order``, as one burst (``rate``
            None) or at Poisson arrivals of ``rate`` a second, from a
            fresh queue drained by the executor's thread; every result
            bitwise its eager call."""
            ex.queue = serve.RequestQueue(ex.queue.policy, qos=qos)
            s0 = (stats.batches, stats.rows, stats.padded_rows)
            lat, futs = {}, []
            arrive = np.cumsum(gaps) / rate if rate else None
            t0 = time.perf_counter()
            with ex:
                for n_sub, i in enumerate(order):
                    svc, q, tenant = reqs[i]
                    if arrive is not None:
                        delay = arrive[n_sub] - (time.perf_counter() - t0)
                        if delay > 0:
                            time.sleep(delay)
                    t_sub = time.monotonic()
                    fut = ex.submit(svc.name, q, tenant=tenant)
                    fut.add_done_callback(
                        lambda f, i=i, t_sub=t_sub: lat.__setitem__(
                            i, time.monotonic() - t_sub))
                    futs.append((i, fut))
                got = {i: f.result(timeout=600) for i, f in futs}
                wall = time.perf_counter() - t0
            bad = []
            for i, out in got.items():
                a = out if isinstance(out, tuple) else (out,)
                if not all(u.device.type == dev.type and torch.equal(u, v)
                           for u, v in zip(a, eager[i])):
                    bad.append((reqs[i][0].name, int(reqs[i][1].shape[0])))
            check(not bad, f"serve at {rate or 'a burst'}: results differ "
                  f"from eager: {bad[:8]} ({len(bad)})")
            ls = sorted(lat.values())
            batches, rows, padded = (stats.batches - s0[0],
                                     stats.rows - s0[1],
                                     stats.padded_rows - s0[2])
            return {"offered_per_s": rate, "wall_s": wall,
                    "served_per_s": len(reqs) / wall, "batches": batches,
                    "rows_per_launch": rows / batches,
                    "padded_share": padded / (rows + padded),
                    "latency_ms": {"p50": 1e3 * ls[len(ls) // 2],
                                   "p99": 1e3 * ls[min(
                                       len(ls) - 1, int(0.99 * len(ls)))],
                                   "max": 1e3 * ls[-1]}}

        stats = ex.stats
        kernels.reset_launch_counts()
        # the executor's saturation throughput: every request at once,
        # its latency the queue's drain; then Poisson arrivals at shares
        # of that measured rate
        burst = run(None)
        KEPT["serve_burst_per_s"] = burst["served_per_s"]
        sweep = [dict(run(share * burst["served_per_s"]), share=share)
                 for share in SERVE_LOADS]
        launches = kernels.launch_counts()
        served_by = {n: dict(t) for n, t in by_service.items()}
        med = {s: {b: statistics.median(v) for b, v in sorted(d.items())}
               for s, d in timing.items()}
        # the deadline probe: 1 ms behind a full batch of the radix
        # service
        slow = svcs[1][0]
        full = rng.standard_normal((SERVE_MAX_BATCH, slow.dim)).astype(
            np.float32)
        ex.queue = serve.RequestQueue(ex.queue.policy, qos=qos)
        with ex:
            f_full = ex.submit(slow.name, full)
            f_late = ex.submit(slow.name, full[:1], deadline_s=0.001)
            f_full.result(timeout=600)
            try:
                f_late.result(timeout=600)
                late = None
            except limits.DeadlineExceededError as e:
                late = type(e).__name__
        check(late == "DeadlineExceededError",
              f"serve: a 1 ms deadline behind a full batch gave {late}")
        check(stats.traces == traces_at_warm,
              f"serve: {stats.traces - traces_at_warm} builds, exports or "
              "captures after warm()")
        for svc, _, want_k in svcs:
            for name in want_k:
                check(served_by.get(svc.name, {}).get(name, 0) > 0,
                      f"serve: {svc.name} never launched {name}")
            check(sum(served_by.get(svc.name, {}).values()) > 0,
                  f"serve: {svc.name} launched no kernel")
        for name in ("knn_k64_l2", "knn_k1024_l2", "pairwise_l2_expanded",
                     "kmeans_predict_k1024"):
            check(name not in fallbacks,
                  f"serve: {name} fell back from its exported program")
        exported_vs_eager = serve_exported_vs_eager(ex, svcs, dev)
        budget = serve_budget_probes(ex, svcs, rng, dev)
        check(stats.traces == traces_at_warm,
              f"serve: {stats.traces - traces_at_warm} builds, exports or "
              "captures after warm()")
    emit("serve", services={s.name: {"requests": c, "dim": s.dim}
                            for s, c, _ in svcs},
         tenants=SERVE_TENANTS, policy=[SERVE_MAX_BATCH, SERVE_WAIT_MS],
         ladder=serve.bucket_ladder(SERVE_MAX_BATCH), executables=n_exec,
         warm_s=warm_s, warm_s_by_service=warm_by,
         export_s_by_service=build_s, aot_fallback=fallbacks,
         traces_at_warm=traces_at_warm, traces_after_warm=0,
         requests=len(reqs), burst=burst, sweep=sweep,
         coalescing=stats.coalescing_factor(),
         launch_ms_median_by_bucket=med, launches_by_service=served_by,
         exported_vs_eager_ms=exported_vs_eager,
         deadline_probe=late, budget_probes=budget, bitwise_eager=True,
         seconds=time.perf_counter() - t_phase,
         note="burst: every request submitted at once, latency = the "
              "queue's drain; sweep: Poisson arrivals at shares of the "
              "burst's served rate; launch ms over the burst and sweep")
    return {n: c for n, c in launches.items() if c}


def serve_exported_vs_eager(ex, svcs, dev):
    """Each service's warmed executable (the exported program, or the
    eager callable it fell back to) against the eager callable it was
    exported from, at every bucket, through the executor's launch (pad
    already done, the copy in, the wait): median ms of 3 each, in turns
    (exported, eager, eager, exported)."""
    import statistics

    import numpy as np
    import torch

    from raft_tpu_torch import serve

    out = {}
    for svc, _, _ in svcs:
        serving = svc.serving()
        tier = ex._tier(svc, serving[0])
        fn = svc._build_for(serving)
        rows = {}
        for b in serve.bucket_ladder(SERVE_MAX_BATCH):
            exe = ex._executables[(svc.name, serving[0], b)]
            q = torch.from_numpy(np.random.default_rng(SEED + 41 + b)
                                 .standard_normal((b, svc.dim))
                                 .astype(np.float32)).to(dev)
            times = {"exported": [], "eager": []}
            serve.Executor._call(ex, svc, fn, serving[1], q, tier)
            for name, f in (("exported", exe), ("eager", fn), ("eager", fn),
                            ("exported", exe)):
                for _ in range(3):
                    t0 = time.perf_counter()
                    serve.Executor._call(ex, svc, f, serving[1], q, tier)
                    times[name].append((time.perf_counter() - t0) * 1e3)
            rows[b] = {k: statistics.median(v) for k, v in times.items()}
        out[svc.name] = {"is_export": isinstance(
            ex._executables[(svc.name, serving[0], SERVE_MAX_BATCH)],
            torch.nn.Module), "ms": rows}
    return out


def serve_budget_probes(ex, svcs, rng, dev):
    """Budgets under the 256-row bucket's estimate, on the warmed
    executor, drained on this thread: a coalesced kNN batch splits into
    warmed halves (bitwise); a lone 256-row request degrades under
    ``budget_scope`` (``knn``'s tile cap at k = 64 and 1024,
    ``pairwise_distance``'s row blocks; bitwise eager); a budget below
    the operands alone rejects with ``RejectedError``. Last, one degrade
    through the running drain thread (bitwise eager at the tier the
    services were warmed at)."""
    import numpy as np
    import torch

    from raft_tpu_torch import serve
    from raft_tpu_torch.runtime import limits

    out = {}

    def drain():
        while ex.queue.pending():
            ex.dispatch(ex.queue.next_batch(timeout=1.0))

    def same(a, b):
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        return all(torch.equal(u, v) for u, v in zip(a, b))

    qos = ex.qos
    # the drain thread has stopped and closed its queue: a fresh one,
    # drained on this thread
    ex.queue = serve.RequestQueue(ex.queue.policy)
    try:
        for svc in (svcs[0][0], svcs[1][0], svcs[2][0]):
            ex.qos = serve.QosPolicy(budget=limits.WorkBudget(
                svc.estimate_bytes(SERVE_MAX_BATCH) - 1))
            s0, d0 = ex.stats.splits, ex.stats.degraded
            qs = [rng.standard_normal((64, svc.dim)).astype(np.float32)
                  for _ in range(4)]
            futs = [ex.submit(svc.name, q) for q in qs]
            drain()
            split_ok = all(same(f.result(timeout=60), svc.eager(q))
                           for q, f in zip(qs, futs))
            big = np.concatenate(qs)
            fut = ex.submit(svc.name, big)
            drain()
            got = fut.result(timeout=600)
            degraded_ok = same(got, svc.eager(big))
            check(ex.stats.splits > s0 and split_ok,
                  f"serve budget {svc.name}: no split, or its bits differ")
            check(ex.stats.degraded == d0 + 1 and degraded_ok,
                  f"serve budget {svc.name}: the degraded request's bits "
                  "differ from eager")
            out[svc.name] = {"budget": svc.estimate_bytes(
                SERVE_MAX_BATCH) - 1, "splits": ex.stats.splits - s0,
                "degraded": 1, "bitwise": True}
        svc = svcs[2][0]
        corpus = svc.fixed_args[0]
        # below the operands alone: no row block can fit
        ex.qos = serve.QosPolicy(budget=limits.WorkBudget(
            (SERVE_MAX_BATCH + corpus.shape[0]) * corpus.shape[1]
            * corpus.element_size() - 1))
        fut = ex.submit(svc.name, rng.standard_normal(
            (SERVE_MAX_BATCH, svc.dim)).astype(np.float32))
        drain()
        try:
            fut.result(timeout=60)
            rejected = None
        except limits.RejectedError as e:
            rejected = {"op": e.op, "estimate": e.estimate,
                        "budget": e.budget}
        check(rejected is not None and rejected["op"] ==
              "distance.pairwise_distance",
              f"serve budget: below the operands gave {rejected}, want "
              "RejectedError")
        out["rejected"] = rejected
        # a degrade through the running drain thread, whose own tier is
        # the process's: the request keeps the warmed tier's bits
        svc = svcs[0][0]
        ex.qos = serve.QosPolicy(budget=limits.WorkBudget(
            svc.estimate_bytes(SERVE_MAX_BATCH) - 1))
        ex.queue = serve.RequestQueue(ex.queue.policy)
        d0 = ex.stats.degraded
        big = rng.standard_normal((SERVE_MAX_BATCH, svc.dim)).astype(
            np.float32)
        with ex:
            got = ex.submit(svc.name, big).result(timeout=600)
        check(ex.stats.degraded == d0 + 1 and same(got, svc.eager(big)),
              f"serve budget {svc.name}: a degrade on the drain thread is "
              "not bitwise its eager call at the warmed tier")
        out["drain_thread_degrade"] = {"service": svc.name,
                                       "bitwise": True}
    finally:
        ex.qos = qos
    return out


class FleetTarget:
    """A replica group in the place of ``loadgen.open_loop``'s executor:
    submits go through the group's router (hedged when it hedges), its
    stats are the replicas' summed."""

    def __init__(self, group):
        self.group = group
        self.qos = None

    def _service(self, op):
        return self.group.replicas[0].executor._service(op)

    def submit(self, op, queries, *, tenant="default", deadline_s=None):
        return self.group.submit(op, queries, tenant=tenant,
                                 deadline_s=deadline_s)

    @property
    def stats(self):
        from raft_tpu_torch import serve

        s = serve.ExecutorStats()
        for r in self.group.replicas:
            t = r.executor.stats
            s.batches += t.batches
            s.rows += t.rows
            s.padded_rows += t.padded_rows
            for lvl, n in t.brownout_levels.items():
                s.brownout_levels[lvl] = s.brownout_levels.get(lvl, 0) + n
        return s


class KeptRequests:
    """Every request the given executors admit (their ``submit_request``
    wrapped), with its completion time, and the caller's future of each
    hedged submit (a group's hedger ``watch`` wrapped): what the
    serve_fleet checks hold against eager calls after the run."""

    def __init__(self, exs):
        import threading

        self.lock = threading.Lock()
        self.reqs, self.outer, self.done_at = [], [], {}
        for ex in exs:
            self._wrap(ex)

    def _wrap(self, ex):
        orig = ex.submit_request

        def submit_request(op, queries, _orig=orig, _ex=ex, **kw):
            req = _orig(op, queries, **kw)
            req.future.add_done_callback(
                lambda f, r=req: self.done_at.__setitem__(
                    id(r), time.monotonic()))
            with self.lock:
                self.reqs.append((_ex, req))
            return req
        ex.submit_request = submit_request

    def watch(self, group):
        hedger = group._hedger
        orig = hedger.watch

        def watch(replica, req):
            outer = orig(replica, req)
            with self.lock:
                self.outer.append((replica.executor, req, outer))
            return outer
        hedger.watch = watch

    def take(self):
        with self.lock:
            out = (self.reqs, self.outer)
            self.reqs, self.outer = [], []
        return out


def fleet_latencies(kept, pairs, split=None):
    """p50/p99 ms (submit to completion) of the served requests of
    ``pairs``, all or split at the monotonic instant ``split``."""
    import numpy as np

    def pct(lat):
        if not lat:
            return None
        a = np.asarray(lat)
        return {"n": len(lat), "p50": float(np.percentile(a, 50)),
                "p99": float(np.percentile(a, 99))}

    rows = [(r.t_enqueue, 1e3 * (kept.done_at[id(r)] - r.t_enqueue))
            for _, r in pairs if id(r) in kept.done_at
            and r.future.exception(timeout=0) is None]
    if split is None:
        return pct([lat for _, lat in rows])
    return {"before": pct([lat for t, lat in rows if t < split]),
            "after": pct([lat for t, lat in rows if t >= split])}


def fleet_check(name, pairs, outers, order, least=None):
    """Hold one scenario's responses to eager calls: every future
    resolved (served, or failed typed: none lost or hanging); ``least``
    served responses, in the order the seed chose before the run, plus
    every hedge leg that served and the caller's future of every hedged
    submit, each bitwise the eager call of the service at its stamped
    level (and that service is its ladder's level)."""
    from raft_tpu_torch.runtime import limits

    least = FLEET_CHECKED if least is None else least
    typed, reasons = 0, {}
    for _, r in pairs:
        try:
            r.future.result(timeout=120)
        except (limits.RejectedError, limits.DeadlineExceededError) as e:
            typed += 1
            why = getattr(e, "reason", None) or type(e).__name__
            reasons[why] = reasons.get(why, 0) + 1
        except TimeoutError:
            check(False, f"serve_fleet {name}: a future never resolved")
    for ex, r in pairs:
        if ex.brownout is not None:
            lad = next(iter(ex.brownout.ladders.values()))
            check(lad.service(r.level).name == r.op,
                  f"serve_fleet {name}: {r.op} stamped level {r.level}")

    def same(ex, r, got):
        return same_bits(got, ex.services[r.op].eager(r.queries))

    checked = 0
    for i in order:
        if checked >= least:
            break
        if i >= len(pairs):
            continue
        ex, r = pairs[i]
        if r.future.exception(timeout=0) is not None:
            continue
        check(same(ex, r, r.future.result(timeout=0)),
              f"serve_fleet {name}: request {i} ({r.op}, level "
              f"{r.level}) differs from its eager call")
        checked += 1
    check(checked >= least, f"serve_fleet {name}: {checked} served "
          f"responses to check, want {least}")
    hedged = {id(r.queries) for _, r in pairs if r.hedge}
    legs = 0
    for ex, r in pairs:
        if id(r.queries) in hedged and r.future.exception(timeout=0) is None:
            check(same(ex, r, r.future.result(timeout=0)),
                  f"serve_fleet {name}: a hedge leg differs from eager")
            legs += 1
    callers = 0
    for ex, r, outer in outers:
        if id(r.queries) in hedged:
            try:
                got = outer.result(timeout=120)
            except (limits.RejectedError, limits.DeadlineExceededError):
                continue
            check(same(ex, r, got), f"serve_fleet {name}: a hedged "
                  "response differs from eager")
            callers += 1
    return {"requests": len(pairs), "typed_failures": typed,
            "typed_reasons": reasons, "checked": checked,
            "hedge_legs_checked": legs, "hedged_responses_checked": callers}


def ladder_probe(ex, ctl, rows_list, tenant="probe"):
    """Drive a brownout executor into each level of its ladder once
    (hot ticks on an injected clock, drained on this thread): at each
    level the same queries, one request of each of ``rows_list`` rows,
    served at that level's service. Returns ``[(level, request), ...]``."""
    import numpy as np

    lad = next(iter(ctl.ladders.values()))
    rng = np.random.default_rng(SEED + 61)
    qs = [rng.standard_normal((rows, lad.services[0].dim)).astype(
        np.float32) for rows in rows_list]
    out, now = [], 1e6
    for level in range(lad.depth):
        check(ctl.level(lad.op, tenant) == level,
              f"ladder probe: controller at {ctl.level(lad.op, tenant)}, "
              f"want {level}")
        for q in qs:
            req = ex.submit_request(lad.op, q, tenant=tenant)
            while ex.queue.pending():
                ex.dispatch(ex.queue.next_batch(timeout=1.0))
            out.append((level, req))
        now += 10.0 * ctl.step_interval_s
        ctl.tick(queue_frac=0.0, burn_by_tenant={tenant: 9.0}, now=now)
    return out


def serve_fleet_phase(res, dev, db, ivf_index):
    """The serving fleet at full width, on the kNN database (2^20 x 128
    f32, 'high'; one tensor shared by every replica and ladder level):
    ``FLEET_REPLICAS`` executors behind a ``ReplicaGroup`` serving
    ``KnnService(k = 64)`` (buckets 8 .. 64, each replica with a
    ``FaultInjector``), warmed once. One executor's closed-loop rate,
    then the fleet's (its saturation), both under ``FLEET_CLIENTS``
    clients; open-loop arrivals at
    ``SERVE_LOADS`` shares of that rate; the slow-replica scenario
    (duty-cycled stall) without and with hedging; a replica killed mid
    spike and the write leader killed. Then the brownout: an executor
    over ``knn_ladder(db, BROWN_KS)`` measures its own closed-loop rate
    (metrics off, so no SLO burn is recorded and every response is at
    level 0), then runs the traffic step from ``BROWN_BASE_SHARE`` of
    that rate and the hog tenant (metrics on, which the SLO burn needs;
    every tenant has the SLO ``BROWN_SLO_S``), a forged floor
    violation is flight-recorded, and each ladder (the kNN one, and
    ``ivf_ladder`` at nprobe ``IVF_LADDER`` over the ivf phase's index at
    two buckets) is driven into each level once. Checks: every scenario's
    responses (``FLEET_CHECKED`` chosen by the seed, plus every hedged
    one) bitwise their eager call at the stamped level; no build, export
    or capture after ``warm()``; the hedge rate within its budget; every
    future of a killed replica resolved, typed; a finite recovery to the
    SLO; ``fused_topk`` and the radix kernels launched. Returns the
    launches."""
    import numpy as np

    from raft_tpu_torch import kernels, obs, serve
    from raft_tpu_torch.comms.faults import FaultInjector
    from raft_tpu_torch.obs import metrics as obs_metrics
    from raft_tpu_torch.serve import loadgen
    from raft_tpu_torch.util import precision as tprec

    t_phase = time.perf_counter()
    op = f"knn_k{FLEET_K}_l2"

    def policy(max_batch, max_queue=4096):
        return serve.BatchPolicy(max_batch=max_batch,
                                 max_wait_ms=FLEET_WAIT_MS,
                                 max_queue=max_queue)

    def fresh(*exs):
        # a stopped executor's queue is closed: the next run gets a new
        # one (the warmed programs stay)
        for ex in exs:
            ex.queue = serve.RequestQueue(ex.queue.policy, qos=ex.qos)

    injs = [FaultInjector(seed=SEED + i) for i in range(FLEET_REPLICAS)]
    exs = [serve.Executor(
        [serve.KnnService(db, k=FLEET_K)], policy=policy(FLEET_MAX_BATCH),
        qos=serve.QosPolicy({"default": serve.TenantPolicy(
            slo_latency_s=FLEET_SLO_S)}), faults=inj) for inj in injs]
    bqos = serve.QosPolicy({
        "default": serve.TenantPolicy(slo_latency_s=BROWN_SLO_S),
        "hog": serve.TenantPolicy(slo_latency_s=BROWN_SLO_S),
        "light": serve.TenantPolicy(slo_latency_s=BROWN_SLO_S,
                                    min_quality=0)})
    bqos.SLO_WINDOW_S = 0.5
    knn_lad = serve.knn_ladder(db, BROWN_KS)
    check(all(s.fixed_args[0] is db for s in knn_lad.services)
          and all(ex.services[op].fixed_args[0] is db for ex in exs),
          "serve_fleet: a replica or ladder level copied the database")
    ctl = serve.BrownoutController([knn_lad], qos=bqos, queue_high=0.5,
                                   step_interval_s=0.1, window_s=0.2,
                                   clean_windows=2)
    check(ctl.enabled, "serve_fleet: RAFT_TPU_BROWNOUT is off")
    bex = serve.Executor([], policy=policy(BROWN_MAX_BATCH, 256), qos=bqos,
                         brownout=ctl)
    iex = ictl = None
    if ivf_index is not None:
        ictl = serve.BrownoutController(
            [serve.ivf_ladder(ivf_index, FLEET_K, IVF_LADDER)], enabled=True)
        iex = serve.Executor([], policy=policy(IVF_LADDER_MAX_BATCH),
                             brownout=ictl)
    all_exs = exs + [bex] + ([iex] if iex is not None else [])
    out = {}
    with tprec.scope("high"):
        warm_s, n_exec = {}, 0
        for name, ex in [(f"replica{i}", e) for i, e in enumerate(exs)] + [
                ("brownout_knn", bex)] + ([("brownout_ivf", iex)]
                                          if iex is not None else []):
            t0 = time.perf_counter()
            n_exec += ex.warm()
            warm_s[name] = time.perf_counter() - t0
        traces0 = [ex.stats.traces for ex in all_exs]
        kept = KeptRequests(all_exs)
        scen, orders = {}, {}

        def run(name, fn):
            # the responses to check are chosen by the seed before the run
            orders[name] = np.random.default_rng(
                SEED + 62 + len(orders)).permutation(1 << 17)
            t0 = time.monotonic()
            rep = fn()
            scen[name] = kept.take() + (t0,)
            return rep

        kernels.reset_launch_counts()
        # one executor alone, then the fleet: the saturation rates
        with exs[0]:
            one = run("single", lambda: loadgen.closed_loop(
                exs[0], op, clients=FLEET_CLIENTS, rows=FLEET_ROWS,
                duration_s=FLEET_PHASE_S, seed=SEED + 70))
        fresh(exs[0])
        group = serve.ReplicaGroup(exs)
        with group:
            sat = run("fleet_closed", lambda: loadgen.fleet_closed_loop(
                group, op, clients=FLEET_CLIENTS, rows=FLEET_ROWS,
                duration_s=FLEET_PHASE_S, seed=SEED + 71))
            rate = sat.fleet.qps
            target = FleetTarget(group)
            sweep = run("open_loop", lambda: [loadgen.open_loop(
                target, op, rate_qps=share * rate, rows=FLEET_ROWS,
                duration_s=FLEET_PHASE_S, seed=SEED + 72 + i)
                for i, share in enumerate(SERVE_LOADS)])
        stall_s, duty, period = FLEET_STALL
        slow = {}
        for hedged in (False, True):
            fresh(*exs)
            g = serve.ReplicaGroup(
                exs, hedge=serve.HedgePolicy() if hedged else None)
            if hedged:
                kept.watch(g)
            key = "slow_replica_hedged" if hedged else "slow_replica"
            with g:
                slow[key] = run(key, lambda: loadgen.run_chaos(
                    "slow_replica", g, op, stall_s=stall_s,
                    clients=FLEET_CLIENTS, rows=FLEET_ROWS,
                    phase_s=FLEET_PHASE_S, stall_duty=duty,
                    stall_period_s=period, seed=SEED + 76))
            slow[key + "_stats"] = g.stats
        fresh(*exs)
        group = serve.ReplicaGroup(exs)
        kill_s, kill_at = FLEET_KILL
        with group:
            kills = {"kill_mid_spike": run(
                "kill_mid_spike", lambda: loadgen.run_chaos(
                    "kill_mid_spike", group, op, clients=FLEET_CLIENTS,
                    rows=FLEET_ROWS, phase_s=kill_s, kill_after_s=kill_at,
                    seed=SEED + 77))}
            killed = group.replicas[-1]
            check(not killed.healthy, "serve_fleet: no replica was killed")
            fresh(killed.executor)
            group.rejoin(killed.name)
            kills["kill_leader"] = run(
                "kill_leader", lambda: loadgen.run_chaos(
                    "kill_leader", group, op, clients=FLEET_CLIENTS,
                    rows=FLEET_ROWS, phase_s=kill_s, kill_after_s=kill_at,
                    seed=SEED + 78))
        # the brownout executor: its own saturation rate with metrics
        # off (no SLO outcome is recorded, so the controller stays at
        # level 0), then the scenarios with metrics on (the SLO burn
        # needs them)
        was_enabled = obs.enabled()
        old_reg = obs_metrics.set_registry(obs.MetricsRegistry())
        obs.set_enabled(False)
        try:
            with bex:
                brate = run("brownout_rate", lambda: loadgen.closed_loop(
                    bex, op, clients=FLEET_CLIENTS, rows=FLEET_ROWS,
                    duration_s=FLEET_PHASE_S, seed=SEED + 81))
            fresh(bex)
            check(max(brate.brownout_levels, default=0) == 0,
                  "serve_fleet: the brownout executor degraded with "
                  f"metrics off: {brate.brownout_levels}")
            base_qps = BROWN_BASE_SHARE * brate.qps
            obs.set_enabled(True)
            with bex:
                step = run("traffic_step", lambda: loadgen.run_chaos(
                    "traffic_step", bex, op, base_qps=base_qps,
                    step_factor=BROWN_STEP, rows=FLEET_ROWS,
                    phase_s=FLEET_PHASE_S, seed=SEED + 79))
            fresh(bex)
            with bex:
                hog = run("hog_tenant", lambda: loadgen.run_chaos(
                    "hog_tenant", bex, op,
                    hog_clients=FLEET_CLIENTS * 3 // 4,
                    light_clients=FLEET_CLIENTS // 4,
                    rows=FLEET_ROWS, phase_s=FLEET_PHASE_S,
                    seed=SEED + 80))
            fresh(bex)
            probes = {"knn": ladder_probe(bex, ctl, (4, 11))}
            if iex is not None:
                probes["ivf"] = ladder_probe(iex, ictl, (4, 11))
            # a response stamped below its tenant's floor: admitted past
            # the controller, served, and flight-recorded at finish
            obs.clear_flight_bundles()
            forged = bex.queue.submit_request(
                op, np.zeros((4, db.shape[1]), np.float32), tenant="light",
                level=2)
            bex.dispatch(bex.queue.next_batch(timeout=1.0))
            forged.future.result(timeout=60)
            bundles = obs.flight_bundles("BrownoutFloorError")
            floor_count = sum(
                s_["value"] for s_ in obs.snapshot()["metrics"].get(
                    "serve_brownout_floor_violations_total",
                    {"series": []})["series"])
        finally:
            obs.set_enabled(was_enabled)
            obs_metrics.set_registry(old_reg)
        launches = kernels.launch_counts()
    check(bundles and "min_quality floor" in bundles[-1]["header"]["error"]
          and floor_count == 1,
          "serve_fleet: the floor violation raised no BrownoutFloorError "
          "flight bundle")
    for name in ("fused_topk", "radix_threshold", "radix_emit"):
        check(launches.get(name, 0) > 0,
              f"serve_fleet: the fleet and ladders never launched {name}")
    check([ex.stats.traces for ex in all_exs] == traces0,
          "serve_fleet: builds, exports or captures after warm(): "
          f"{[ex.stats.traces - t for ex, t in zip(all_exs, traces0)]}")
    check(step.retraces_during == 0 and hog.retraces_during == 0,
          "serve_fleet: a brownout step compiled")
    budget = serve.HedgePolicy().budget_fraction
    hstats = slow["slow_replica_hedged_stats"]
    check(slow["slow_replica_hedged"].hedge_rate <= budget
          and hstats.hedge_rate() <= budget,
          f"serve_fleet: hedge rate {hstats.hedge_rate():.4f} over the "
          f"budget {budget}")
    check(hog.notes["light_level"] == 0,
          "serve_fleet: the light tenant (min_quality 0) was degraded")
    # the checks, after the launch counts were read
    checks = {}
    with tprec.scope("high"):
        for name, (pairs, outers, t0) in scen.items():
            checks[name] = fleet_check(name, pairs, outers, orders[name])
        levels = {}
        for lname, probe in probes.items():
            lad = (ictl if lname == "ivf" else ctl).ladders
            lad = next(iter(lad.values()))
            rows, base = [], {}
            for level, req in probe:
                check(req.level == level
                      and req.op == lad.service(level).name,
                      f"serve_fleet {lname} ladder: level {level} served "
                      f"{req.op} at {req.level}")
                got = req.future.result(timeout=60)
                want = lad.service(level).eager(req.queries)
                check(same_bits(got, want),
                      f"serve_fleet {lname} ladder: level {level} differs "
                      "from its service's eager call")
                ids = got[1].cpu().numpy()
                if level == 0:
                    base[req.rows] = ids
                shared = float(np.mean([len(set(a) & set(b)) / len(a)
                                        for a, b in zip(
                                            ids, base[req.rows])]))
                rows.append({"level": level, "service": req.op,
                             "rows": req.rows, "k": int(ids.shape[1]),
                             "ids_shared_with_level0": shared,
                             "bitwise_eager": True})
            levels[lname] = rows
    for key in ("kill_mid_spike", "kill_leader"):
        rec = kills[key].notes["recovery_time_to_slo_s"]
        check(rec is not None and np.isfinite(rec),
              f"serve_fleet {key}: no recovery to the SLO ({rec})")
        check(kills[key].phases["spike"].get("killed") is not None,
              f"serve_fleet {key}: no replica killed")

    def phases(rep):
        return {k: {f: v.get(f) for f in ("completed", "qps", "p50_ms",
                                          "p99_ms", "rejected",
                                          "brownout_levels")}
                for k, v in rep.phases.items()}

    def kill_line(key):
        rep = kills[key]
        pairs, _, t0 = scen[key]
        spike = rep.phases["spike"]
        return {"killed": spike.get("killed"),
                "kill_at_s": spike.get("kill_at_s"),
                "recovery_time_to_slo_s":
                    rep.notes["recovery_time_to_slo_s"],
                "latency_ms": fleet_latencies(
                    kept, pairs, t0 + spike["kill_at_s"]),
                "fleet": {f: spike["fleet"][f] for f in (
                    "completed", "qps", "p50_ms", "p99_ms", "rejected")},
                "per_replica_completed": {
                    n: r["completed"] for n, r in spike["replicas"].items()},
                "spills": spike["spills"],
                "typed_failures": checks[key]["typed_reasons"],
                **({"old_leader": rep.notes["old_leader"],
                    "new_leader": rep.notes["new_leader"],
                    "time_to_new_leader_s":
                        rep.notes["time_to_new_leader_s"]}
                   if key == "kill_leader" else {})}

    hs = slow["slow_replica_hedged_stats"]
    emit("serve_fleet", replicas=FLEET_REPLICAS, k=FLEET_K,
         db=[int(db.shape[0]), int(db.shape[1])],
         buckets=serve.bucket_ladder(FLEET_MAX_BATCH),
         rows_per_request=FLEET_ROWS, clients=FLEET_CLIENTS,
         executables=n_exec, warm_s=warm_s, traces_after_warm=0,
         single_executor_qps=one.qps,
         single_executor_latency_ms=[one.p50_ms, one.p99_ms],
         fleet_saturation_qps=rate,
         fleet_latency_ms=[sat.fleet.p50_ms, sat.fleet.p99_ms],
         fleet_per_replica_completed={n: r.completed for n, r in
                                      sat.per_replica.items()},
         fleet_spills=sat.spills,
         serve_phase_burst_requests_per_s=KEPT.get("serve_burst_per_s"),
         open_loop=[{"share": share, "offered_qps": share * rate,
                     "qps": r.qps, "p50_ms": r.p50_ms, "p99_ms": r.p99_ms,
                     "rejected": r.rejected,
                     "rows_per_launch": r.coalescing_factor}
                    for share, r in zip(SERVE_LOADS, sweep)],
         slow_replica={"stall": {"s": stall_s, "duty": duty,
                                 "period_s": period},
                       "unhedged": phases(slow["slow_replica"]),
                       "hedged": phases(slow["slow_replica_hedged"]),
                       "hedges": {"issued": hs.hedges_issued,
                                  "won": hs.hedges_won,
                                  "suppressed": hs.hedges_suppressed,
                                  "rate": hs.hedge_rate(),
                                  "budget": budget}},
         kill_mid_spike=kill_line("kill_mid_spike"),
         kill_leader=kill_line("kill_leader"),
         brownout={"closed_loop_qps": brate.qps,
                   "closed_loop_latency_ms": [brate.p50_ms, brate.p99_ms],
                   "traffic_step": {
                       "base_share": BROWN_BASE_SHARE,
                       "base_qps": base_qps, "step_factor": BROWN_STEP,
                       "phases": phases(step),
                       "max_level_by_phase": {
                           k: v.get("brownout_max_level", 0)
                           for k, v in step.phases.items()},
                       "max_level": step.brownout_max_level,
                       "recovered": step.brownout_recovered},
                   "hog_tenant": {"phases": phases(hog),
                                  "max_level": hog.brownout_max_level,
                                  "light_level": hog.notes["light_level"],
                                  "controller": hog.notes["controller"]},
                   "slo_s": BROWN_SLO_S,
                   "ladder_levels": levels,
                   "floor_violation": {"flight_bundles": len(bundles),
                                       "counter": floor_count}},
         checked=checks, launches={n: c for n, c in launches.items() if c},
         seconds=time.perf_counter() - t_phase,
         note="one card: every replica launches on the device's default "
              "stream and waits for it; the stall is a host sleep before "
              "a launch; latency_ms before/after splits at the kill")
    return {n: c for n, c in launches.items() if c}


# ---------------------------------------------------------------------------
# the streaming phase: the streaming IVF-Flat index, its journal, compactor,
# drift refit and scrubber, and streaming ingest behind the executor, at the
# ivf phase's scale
# ---------------------------------------------------------------------------

STREAM_SLACK = 64                 # free tail slots a list after a repack
STREAM_BATCH, STREAM_FITS = 4096, 4   # fitting inserts: rows, batches
STREAM_OVERFLOW = 65536           # the insert that overflows into an epoch
STREAM_DELETE = 0.1               # share of the ids deleted
STREAM_NOISE = 0.1                # a fitting row's offset from its centroid
STREAM_SHIFT = 3.0                # the drift rows' shift in every coordinate
STREAM_DRIFT_BATCHES = 8          # most shifted batches before the trigger
STREAM_MAX_BATCH = 64             # the ingest executor's buckets: 8 .. 64
STREAM_SERVICES = ((10, 16), (IVF_RADIX_K, 16))
STREAM_LOOP_S, STREAM_CLIENTS = 10.0, 8
# an ingest batch a second: each shape-changing swap re-warms 14 programs
# (about 5 s, the queries' latency up to 1.5 s meanwhile), so faster
# ingest leaves a loop little else
STREAM_INGEST_ROWS, STREAM_INGEST_S = 32, 1.0
STREAM_CHECKED, STREAM_CHECK_RATE = 500, 0.6   # over both loops
STREAM_RECALL = (0.5, 0.85)       # tests/test_streaming.py:616-617
STREAM_TRAFFIC_ROWS, STREAM_RECALL_Q = 4096, 256


class StreamKept:
    """``loadgen.streaming_loop``'s controller (the ingest controller's
    surface, duck-typed) that keeps, for each query whose ordinal the seed
    chose before the run, its block, its response and every snapshot it
    may have been served from (from the one its service serves at submit,
    which may trail the stream's, to the last published before its
    result), and for every query its submit and result instants."""

    def __init__(self, ctl, chosen):
        import threading

        self.ctl, self.chosen = ctl, chosen
        self.executor, self.stream = ctl.executor, ctl.stream
        self.compactor = ctl.compactor
        self.lock = threading.Lock()
        self.n, self.kept, self.spans = 0, [], []

    @property
    def swaps(self):
        return self.ctl.swaps

    @property
    def refreshes(self):
        return self.ctl.refreshes

    def insert(self, rows, labels=None):
        return self.ctl.insert(rows, labels)

    def delete(self, ids):
        return self.ctl.delete(ids)

    def submit(self, op, queries, **kw):
        with self.lock:
            i, self.n = self.n, self.n + 1
        served = self.executor.services[op]._version
        early = self.stream.recent_snapshots()
        t0 = time.monotonic()
        fut = self.ctl.submit(op, queries, **kw)
        kept = self

        class Future:
            def result(self, timeout=None):
                out = fut.result(timeout=timeout)
                t1 = time.monotonic()
                with kept.lock:
                    kept.spans.append((t0, t1))
                    if i in kept.chosen:
                        snaps = {s.version: s for s in
                                 early + kept.stream.recent_snapshots()
                                 if s.version >= served}
                        kept.kept.append((op, queries, out, [
                            snaps[v] for v in sorted(snaps)]))
                return out
        return Future()


def stream_timed(kernels, launches, fn):
    """``fn()`` synchronized: its value, its seconds, and its launches
    added into ``launches``."""
    import torch

    torch.cuda.synchronize()
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    after = kernels.launch_counts()
    for name in after:
        if after[name] != before[name]:
            launches[name] = launches.get(name, 0) + after[name] - before[name]
    return out, s


def stream_shapes(snap):
    f = snap.flat
    return [tuple(t.shape) for t in (f.centroids, f.packed_db, f.packed_ids,
                                     f.starts, f.sizes, snap.tomb_words)]


def stream_near(rng, cents, rows, shift=0.0):
    """``rows`` rows next to the given centroids (host f32)."""
    import numpy as np

    lab = rng.integers(0, cents.shape[0], rows)
    return (cents[lab] + shift + STREAM_NOISE * rng.standard_normal(
        (rows, cents.shape[1]))).astype(np.float32)


def stream_recall(knn, res, idx, q, k=10, nprobe=16, chunk=64):
    """recall@k of ``idx.search`` at ``nprobe`` against ``knn`` over the
    live rows: the mean over the rows of ``q`` and the least mean over
    4-row blocks (the loop's requests), in ``chunk``-row searches."""
    import torch

    rows, ids = idx._live_device()
    got = torch.cat([idx.search(q[i:i + chunk], k, nprobe)[1]
                     for i in range(0, len(q), chunk)]).long()
    truth = ids[torch.cat([knn(res, rows, q[i:i + chunk], k)[1]
                           for i in range(0, len(q), chunk)]).long()]
    hit = (got[:, :, None] == truth[:, None, :]).any(-1).float().mean(1)
    return {"mean": float(hit.mean()),
            "min_4_rows": float(hit.reshape(-1, 4).mean(1).min())}


def stream_pct(lat):
    import numpy as np

    if not lat:
        return None
    a = np.asarray(lat)
    return {"n": len(lat), "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99))}


def stream_mutations(st, ivf_flat, knn, res, idx, q, rng, kernels,
                     launches, out):
    """Fitting inserts, the overflowing insert, the deletes and the
    searches against the rebuild and against ``knn``."""
    import numpy as np

    cents = idx.flat.centroids.cpu().numpy()
    shapes, epoch = stream_shapes(idx.snapshot), idx.epoch
    fit_ms = []
    for _ in range(STREAM_FITS):
        rows = stream_near(rng, cents, STREAM_BATCH)
        _, s = stream_timed(kernels, launches, lambda: idx.insert(rows))
        fit_ms.append(1e3 * s)
        check(idx.epoch == epoch and stream_shapes(idx.snapshot) == shapes,
              "streaming: a fitting insert changed a snapshot shape")
    out["insert_fit_ms"] = fit_ms
    rows = stream_near(rng, cents, STREAM_OVERFLOW)
    _, s = stream_timed(kernels, launches, lambda: idx.insert(rows))
    check(idx.epoch > epoch, "streaming: the overflowing insert kept "
          "its epoch")
    out["insert_overflow_ms"] = 1e3 * s
    out["rows_after_inserts"] = idx.next_id
    victims = rng.choice(idx.next_id, int(STREAM_DELETE * idx.next_id),
                         replace=False)
    live0 = idx.n_live
    shapes = stream_shapes(idx.snapshot)
    n_del, s = stream_timed(kernels, launches, lambda: idx.delete(victims))
    check(n_del == len(victims) and idx.n_live == live0 - n_del
          and stream_shapes(idx.snapshot) == shapes,
          "streaming: the delete's count or shapes")
    out["delete"] = {"ids": int(n_del), "ms": 1e3 * s}
    rows_l, ids_l = idx._live_device()
    rebuilt = st._flat_from_live(rows_l, ids_l, idx.flat.centroids,
                                 idx.flat.metric)
    searches = {}
    for k in (10, IVF_RADIX_K):
        use_radix = ivf_flat._use_radix(16 * idx.flat.cap_max, k)
        got, s = stream_timed(kernels, launches, lambda: idx.search(q, k, 16))
        want = ivf_flat._search_body(
            q, rebuilt.centroids, rebuilt.packed_db, rebuilt.packed_ids,
            rebuilt.starts, rebuilt.sizes, k=k, nprobe=16,
            cap_max=rebuilt.cap_max, metric=rebuilt.metric,
            use_radix=use_radix)
        check(same_bits(got, want), f"streaming: the tombstoned search at "
              f"k = {k} is not bitwise its rebuild's")
        check(not np.isin(got[1].cpu().numpy(), victims).any(),
              "streaming: a deleted id came back")
        flat_ms = cuda_ms(lambda: ivf_flat.search(res, idx.flat, q, k, 16),
                          3)
        searches[f"k{k}"] = {"ms": 1e3 * s, "use_radix": use_radix,
                             "bitwise_rebuild": True,
                             "tombstoned_ms": cuda_ms(
                                 lambda: idx.search(q, k, 16), 3),
                             "ivf_flat_search_ms": flat_ms}
    check(searches[f"k{IVF_RADIX_K}"]["use_radix"],
          "streaming: k = 64 at nprobe 16 is not on the radix route")
    got, s = stream_timed(kernels, launches,
                          lambda: idx.search(q, 10, IVF_LISTS))
    bd, bi = knn(res, rows_l, q, 10)
    want = (bd, ids_l.to(bi.dtype)[bi.long()])
    check(same_bits(got, want), "streaming: the exact path is not bitwise "
          "knn over the live rows")
    searches["exact"] = {"ms": 1e3 * s, "bitwise_knn": True}
    out["search"] = searches
    del rebuilt, rows_l, ids_l
    return victims


def stream_compact_refit(idx, q, rng, kernels, launches, out, jdir):
    """The compaction (content and search bits kept), then shifted rows
    until the drift gauge fires, and the refit."""
    import torch

    bits = idx.search(q, 10, 16)
    crc, s = stream_timed(kernels, launches, idx.content_crc)
    out["content_crc_s"] = s
    _, s = stream_timed(kernels, launches, idx.live_rows)
    out["live_rows_s"] = s
    check(idx.tombstone_fraction() > 0, "streaming: nothing to compact")
    _, s = stream_timed(kernels, launches,
                        lambda: idx.compact(reason="test"))
    check(idx.content_crc() == crc and same_bits(idx.search(q, 10, 16), bits)
          and idx.tombstone_fraction() == 0.0,
          "streaming: the compaction changed the content or the bits")
    out["compact_s"] = s
    cents = idx.flat.centroids.cpu().numpy()
    ids0 = idx._live_device()[1]
    batches = 0
    while not idx.drift.triggered and batches < STREAM_DRIFT_BATCHES:
        rows = stream_near(rng, cents, STREAM_BATCH, shift=STREAM_SHIFT)
        stream_timed(kernels, launches, lambda: idx.insert(rows))
        batches += 1
    check(idx.drift.triggered, "streaming: the drift gauge never fired")
    ratio = idx.drift.ratio
    ids1 = idx._live_device()[1]
    c0 = idx.flat.centroids.clone()
    ran, s = stream_timed(kernels, launches, idx.maybe_refit)
    check(ran and not torch.equal(c0, idx.flat.centroids),
          "streaming: the refit did not move the centroids")
    check(torch.equal(idx._live_device()[1], ids1)
          and bool(torch.isin(ids0, ids1).all()),
          "streaming: the refit lost an id")
    ckpts = [f for f in os.listdir(os.path.join(jdir, "refit"))
             if f.startswith("kmeans_pf-")]
    check(ckpts, "streaming: the refit wrote no checkpoint")
    out["refit"] = {"batches": batches, "drift_ratio": ratio, "s": s,
                    "checkpoints": len(ckpts),
                    "centroid_shift": float((idx.flat.centroids - c0)
                                            .norm(dim=1).mean()),
                    "baseline_reset": not idx.drift.triggered}
    # WAL records past the refit's epoch, for the recovery to replay
    cents = idx.flat.centroids.cpu().numpy()
    rows = stream_near(rng, cents, STREAM_BATCH)
    stream_timed(kernels, launches, lambda: idx.insert(rows))
    stream_timed(kernels, launches,
                 lambda: idx.delete(rng.choice(idx.next_id, 1000,
                                               replace=False)))


def stream_recover_scrub(st, Scrubber, FaultInjector, device_resources,
                         res, idx, q, kernels, launches, out, jdir):
    """Recovery on the card and on the host, then the scrubber: a clean
    pass, a corrupted epoch file, a flipped byte of the packed rows on
    the card."""
    import torch

    crc = idx.content_crc()
    rec, s = stream_timed(kernels, launches,
                          lambda: st.StreamingIndex.recover(res, jdir))
    check(rec.content_crc() == crc, "streaming: the recovered CRC differs")
    for k in (10, IVF_RADIX_K):
        check(same_bits(rec.search(q, k, 16), idx.search(q, k, 16)),
              f"streaming: the recovered search at k = {k} differs")
    t0 = time.perf_counter()
    cpu_rec = st.StreamingIndex.recover(device_resources("cpu"), jdir)
    cpu_s = time.perf_counter() - t0
    check(cpu_rec.content_crc() == crc,
          "streaming: the host recovery's CRC differs")
    out["recover"] = {"s": s, "cpu_s": cpu_s, "crc": crc,
                      "replayed_epoch": rec.epoch, "n_live": rec.n_live}
    del cpu_rec
    sc = Scrubber(idx, interval=60.0,
                  repair_source=lambda: st._epoch_entries(rec))
    n_files = len([f for f in os.listdir(jdir) if f.endswith(".ckpt")])
    rep, s = stream_timed(kernels, launches, sc.run_once)
    check(rep.files_checked == n_files and not rep.corrupt,
          f"streaming: the clean scrub saw {rep}")
    scrub = {"files": rep.files_checked, "pass_s": s}
    newest = idx.log.epoch_path(max(idx.log.epoch_steps()))
    FaultInjector().corrupt_bytes(newest)
    name = os.path.basename(newest)
    rep, s = stream_timed(kernels, launches, sc.run_once)
    check(rep.corrupt == [name] == rep.quarantined == rep.repaired
          and os.path.exists(newest + ".quarantined")
          and os.path.exists(newest),
          f"streaming: the corrupted epoch was not repaired: {rep}")
    scrub["epoch_repair_s"] = s
    flat = idx.snapshot.flat
    slot = int(torch.nonzero(flat.packed_ids >= 0)[0, 0])
    raw = flat.packed_db.view(torch.uint8).view(-1)
    raw[slot * flat.packed_db.shape[1] * flat.packed_db.element_size()
        + 2] ^= 0xFF
    check(idx.content_crc() != crc, "streaming: the flipped byte is not "
          "in the content")
    rep, s = stream_timed(kernels, launches, sc.run_once)
    check(rep.memory_repaired and idx.content_crc() == crc
          and same_bits(idx.search(q, 10, 16), rec.search(q, 10, 16)),
          "streaming: the flipped device byte was not repaired")
    scrub["memory_repair_s"] = s
    out["scrub"] = scrub
    del rec


def stream_ingest(st, serve, res, dev, idx, rng, kernels, launches, out):
    """An IngestController over the k = 10 and k = 64 services, warmed
    at buckets 8 .. 64: a same-shape swap, then ``streaming_loop`` once
    an op, every chosen response (at least ``STREAM_CHECKED`` in all)
    held bitwise to an eager search of one of the snapshots of its
    window, and no compile on the query path."""
    import numpy as np
    import torch

    from raft_tpu_torch.neighbors import knn

    # streaming_loop's queries and inserts are N(0, I) rows, which the
    # blobs' database does not hold: a query's exact neighbours would be
    # mostly the loop's own newest inserts, and its recall would measure
    # how far the served snapshot trails the stream more than the search.
    # Rows of that distribution go in first, as the reference test's
    # database, queries and inserts share one distribution; the line gives
    # the search's recall on queries drawn as the loop draws them, before
    # and after.
    draw = np.random.default_rng(SEED + 62)
    qd = torch.from_numpy(draw.standard_normal(
        (STREAM_RECALL_Q, idx.flat.dim)).astype(np.float32)).to(dev)
    ing = {"recall_blobs_only": stream_recall(knn, res, idx, qd)}
    rows = draw.standard_normal(
        (STREAM_TRAFFIC_ROWS, idx.flat.dim)).astype(np.float32)
    stream_timed(kernels, launches, lambda: idx.insert(rows))
    ing["traffic_rows"] = STREAM_TRAFFIC_ROWS
    ing["recall_with_traffic_rows"] = stream_recall(knn, res, idx, qd)
    svcs = [serve.StreamingKnnService(idx, k=k, nprobe=p)
            for k, p in STREAM_SERVICES]
    ctl = serve.IngestController(
        idx, svcs, policy=serve.BatchPolicy(max_batch=STREAM_MAX_BATCH,
                                            max_wait_ms=2.0),
        compact_interval=0.25, refit=False)
    _, ing["warm_s"] = stream_timed(kernels, launches,
                                    lambda: ctl.executor.warm())
    warm_traces = ctl.executor.stats.traces
    ing["warm_traces"] = warm_traces
    chosen = {int(i) for i in np.flatnonzero(
        rng.random(1 << 17) < STREAM_CHECK_RATE)}
    cents = idx.flat.centroids.cpu().numpy()
    loops = {}
    try:
        ctl.start(warm=False)
        # a same-shape swap: a delete and a fitting insert serve at once
        swaps, epochs = ctl.swaps, [s.serve_epoch for s in svcs]
        stream_timed(kernels, launches, lambda: ctl.delete(
            idx.live_rows()[1][:16]))
        stream_timed(kernels, launches, lambda: ctl.insert(
            stream_near(rng, cents, 64)))
        qq = stream_near(rng, cents, 8)
        got = ctl.submit(svcs[0].name, qq).result(timeout=60.0)
        check(ctl.swaps == swaps
              and [s.serve_epoch for s in svcs] == epochs
              and ctl.executor.stats.traces == warm_traces
              and same_bits(got, idx.search(torch.from_numpy(qq).to(dev),
                                            svcs[0].k, svcs[0].nprobe)),
              "streaming: a same-shape swap did not serve at once")
        for svc in svcs:
            kept = StreamKept(ctl, chosen)
            rep, _ = stream_timed(kernels, launches, lambda: (
                serve.streaming_loop(
                    kept, svc.name, clients=STREAM_CLIENTS, rows=4,
                    duration_s=STREAM_LOOP_S, ingest_rows=STREAM_INGEST_ROWS,
                    ingest_interval_s=STREAM_INGEST_S, delete_frac=0.3,
                    seed=SEED)))
            loops[svc.name] = (rep, kept)
    finally:
        ctl.stop()
    query_traces = (ctl.executor.stats.traces - warm_traces
                    - ctl.rewarm_traces)
    ing["rewarm_traces"] = ctl.rewarm_traces
    ing["query_path_traces"] = query_traces
    ing["swaps"], ing["refreshes"] = ctl.swaps, ctl.refreshes
    ing["rewarm_s"] = [b - a for a, b in ctl.rewarm_windows]
    ing["compactions"] = ctl.compactor.compactions
    ing["loops"] = {}
    out["ingest"] = ing
    for name, (rep, kept) in loops.items():
        swap_lat, calm_lat = [], []
        for t0, t1 in kept.spans:
            busy = any(a < t1 and t0 < b for a, b in ctl.rewarm_windows)
            (swap_lat if busy else calm_lat).append(1e3 * (t1 - t0))
        ing["loops"][name] = {**rep.as_dict(), "checked": len(kept.kept),
                              "latency_in_swap": stream_pct(swap_lat),
                              "latency_no_swap": stream_pct(calm_lat)}
    check(query_traces == 0, f"streaming: the query path compiled "
          f"{query_traces} times after warm()")
    n_checked = sum(len(kept.kept) for _, kept in loops.values())
    check(n_checked >= STREAM_CHECKED,
          f"streaming: only {n_checked} responses checked")
    for name, (rep, kept) in loops.items():
        svc = ctl.executor.services[name]
        check(rep.failed == 0 and rep.swaps >= 1,
              f"streaming: {name}: no swap or a failed query")
        check(rep.min_recall >= STREAM_RECALL[0]
              and rep.mean_recall >= STREAM_RECALL[1],
              f"streaming: {name} under the recall floor")
        later = 0
        for _, qb, got, snaps in kept.kept:
            qt = torch.from_numpy(np.asarray(qb, np.float32)).to(dev)
            for j, snap in enumerate(snaps):
                if same_bits(tuple(got), st._search_snapshot(
                        snap, qt, svc.k, svc.nprobe)):
                    later += j > 0
                    break
            else:
                check(False, f"streaming: {name}: a response matches no "
                      "snapshot of its window")
        ing["loops"][name]["served_a_later_snapshot"] = later


def streaming_phase(res, dev):
    """The streaming index at the ivf phase's scale (2^20 x 64, 1024
    lists, 'high'), journaled under chiprun_out/streaming (removed
    after): build, a provisioning compaction, fitting and overflowing
    inserts, deletes, searches bitwise their rebuild and ``knn``, the
    compaction, a drift refit, recovery on the card and on the host, the
    scrubber's repairs and streaming ingest through the executor.
    Prints one ``streaming`` line; returns the launches by kernel."""
    import shutil

    import numpy as np
    import torch

    from raft_tpu_torch import device_resources, kernels, serve
    from raft_tpu_torch.comms.faults import FaultInjector
    from raft_tpu_torch.neighbors import ivf_flat, knn
    from raft_tpu_torch.neighbors import streaming as st
    from raft_tpu_torch.neighbors.scrub import Scrubber
    from raft_tpu_torch.util import precision as tprec

    root = os.path.abspath(os.path.join(OUT_DIR, "streaming"))
    jdir = os.path.join(root, "journal")
    shutil.rmtree(root, ignore_errors=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    x = blobs(gen, dev, IVF_N, IVF_D, IVF_LISTS)
    q = x[:IVF_Q].clone()
    rng = np.random.default_rng(SEED + 61)
    launches, writes = {}, []
    out = {"db": [IVF_N, IVF_D], "n_lists": IVF_LISTS, "queries": IVF_Q,
           "max_iter": IVF_ITERS, "repack_slack": STREAM_SLACK,
           "epoch_writes": writes}
    t_phase = time.perf_counter()
    try:
        with tprec.scope("high"):
            idx, out["build_s"] = stream_timed(
                kernels, launches, lambda: st.stream_build(
                    res, x, IVF_LISTS, directory=jdir, max_iter=IVF_ITERS,
                    repack_slack=STREAM_SLACK))
            del x
            write = idx._write_epoch_locked

            def timed_write(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                write(*a, **kw)
                writes.append({"epoch": idx._epoch,
                               "s": time.perf_counter() - t0,
                               "bytes": os.path.getsize(
                                   idx.log.epoch_path(idx._epoch))})
            idx._write_epoch_locked = timed_write
            _, out["provision_s"] = stream_timed(
                kernels, launches, lambda: idx.compact(reason="provision"))
            out["cap_max"] = idx.flat.cap_max
            stream_mutations(st, ivf_flat, knn, res, idx, q, rng, kernels,
                             launches, out)
            stream_compact_refit(idx, q, rng, kernels, launches, out, jdir)
            stream_recover_scrub(st, Scrubber, FaultInjector,
                                 device_resources, res, idx, q, kernels,
                                 launches, out, jdir)
            stream_ingest(st, serve, res, dev, idx, rng, kernels, launches,
                          out)
            out["final"] = {"epoch": idx.epoch, "n_live": idx.n_live,
                            "next_id": idx.next_id,
                            "cap_max": idx.flat.cap_max}
    except BaseException as exc:
        # what the phase measured before the failed check, then the raise
        emit("streaming", failed=str(exc), **out)
        raise
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name in ("fused_argmin", "fused_lloyd", "fused_topk",
                 "radix_threshold", "radix_emit"):
        check(launches.get(name, 0) > 0,
              f"streaming: the phase never launched {name}")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    emit("streaming", **out)
    torch.cuda.empty_cache()
    return launches


def same_bits(got, want):
    """Two results (a tensor or a tuple of them) on one device, bit for
    bit."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(
        a.device == b.device and torch.equal(a, b)
        for a, b in zip(got, want))


AOT_CHILD = r"""
import hashlib, json, sys, time
t0 = time.perf_counter()
import torch
from raft_tpu_torch import kernels
from raft_tpu_torch.kernels import build
from raft_tpu_torch.runtime import aot
kernels.load_operators()
dev = torch.device(sys.argv[1])
torch.empty(1, device=dev)
out = {"import_s": time.perf_counter() - t0}
for path, seed, shapes in json.loads(sys.argv[2]):
    t0 = time.perf_counter()
    fn = aot.load_computation(path)
    load_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(seed)
    args = [torch.randn(*s, generator=g, device=dev) for s in shapes]
    t0 = time.perf_counter()
    res = fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    h = hashlib.sha256()
    for o in (res if isinstance(res, (tuple, list)) else (res,)):
        h.update(o.detach().cpu().contiguous().numpy().tobytes())
    out[path] = {"sha256": h.hexdigest(), "load_s": load_s,
                 "first_call_s": run_s}
out["nvcc_runs"] = build.compiles()
print(json.dumps(out))
"""


def aot_phase(res, dev):
    """``runtime.aot`` on the card: ``lloyd_step`` at config 3's shape
    and ``radix_select_k`` at the select shape are exported and saved
    (with the sha256 sidecar), then loaded in one fresh ``python``
    process, which regenerates the inputs from the seed, runs each
    program and hashes its outputs: the hashes must be the eager calls',
    with no ``nvcc`` run in that process (the kernels load from
    ``build/kernels/``)."""
    import functools
    import hashlib
    import shutil
    import tempfile

    import torch

    from raft_tpu_torch.cluster import kmeans as tk
    from raft_tpu_torch.matrix.radix_select import radix_select_k
    from raft_tpu_torch.runtime import aot
    from raft_tpu_torch.util import precision as tprec

    rr, rc, rk = SELECT_RADIX
    cases = (
        ("lloyd_step", functools.partial(tk.lloyd_step, n_clusters=MAIN_N),
         [[MAIN_M, MAIN_K], [MAIN_N, MAIN_K]], SEED + 50, "fused_lloyd"),
        ("radix_select_k", lambda v: radix_select_k(v, rk),
         [[rr, rc]], SEED + 51, "radix_threshold"))
    tmp = tempfile.mkdtemp(dir=OUT_DIR)
    out, jobs, hashes = {}, [], {}
    try:
        for name, fn, shapes, seed, kernel in cases:
            g = torch.Generator(device=dev).manual_seed(seed)
            args = [torch.randn(*s, generator=g, device=dev) for s in shapes]
            with tprec.scope("high"):
                eager = fn(*args)
                t0 = time.perf_counter()
                exp = aot.aot_export(fn, *args)
                export_s = time.perf_counter() - t0
            check(any(f"raft_tpu_torch.{kernel}" in str(nd.target)
                      for nd in exp.graph.nodes),
                  f"aot {name}: no {kernel} operator in the program")
            path = os.path.join(tmp, f"{name}.pt2")
            t0 = time.perf_counter()
            aot.save_computation(exp, path)
            save_s = time.perf_counter() - t0
            h = hashlib.sha256()
            for o in (eager if isinstance(eager, tuple) else (eager,)):
                h.update(o.detach().cpu().contiguous().numpy().tobytes())
            hashes[path] = h.hexdigest()
            jobs.append((path, seed, shapes))
            out[name] = {"shapes": shapes, "export_s": export_s,
                         "save_s": save_s, "bytes": os.path.getsize(path)}
            del args, eager, exp
            torch.cuda.empty_cache()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.getcwd()
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", AOT_CHILD, str(dev), json.dumps(jobs)],
            capture_output=True, text=True, env=env, timeout=600)
        child_s = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"aot: the fresh process failed:\n{proc.stderr}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        check(child["nvcc_runs"] == 0, "aot: the fresh process ran nvcc")
        for (name, *_), (path, _, _) in zip(cases, jobs):
            check(child[path]["sha256"] == hashes[path],
                  f"aot {name}: the loaded program's bits differ")
            out[name].update(load_s=child[path]["load_s"],
                             first_call_s=child[path]["first_call_s"],
                             bitwise=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("aot", tier="high", programs=out, fresh_process_s=child_s,
         fresh_import_s=child["import_s"], nvcc_runs=child["nvcc_runs"])

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
    guards_phase(res, dev)
    x, c, ops, launches, predict_ms = main_path(res, dev)
    KEPT["centroids"] = c.clone()          # the serve phase's operand
    lloyd_plan_phase(dev)
    topk_plan_phase(dev)
    argmin_plan_phase(dev)
    radix_plan_phase()
    small_fit_matches_cpu(res, dev)
    cd_launches = compiled_driver_phase(res, dev, x)
    pairwise_phase(res, dev)
    unexp_launches, unexp_err = unexpanded_pairwise_phase(res, dev)
    table = kernel_numbers(x, c, ops, parity_errs, launches, predict_ms,
                           hgmma)
    for row in table:
        if cd_launches.get(row["name"], 0):
            row["compiled_driver_launches"] = cd_launches[row["name"]]
            row["launches"] += cd_launches[row["name"]]
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
    KEPT["knn_db"] = db                    # the serve phase's database
    del db, q, v_radix, v_ins, v_desc, v_asc
    torch.cuda.empty_cache()

    g, x, b16, c4, c4_launches = config4_phase(res, dev)
    ritz_row = c4.pop("ritz_row")
    ritz_row["launches"] = c4_launches["sym_eig_jacobi"]
    part_launches, part_errs, argmin_row["partition_shape"] = \
        partition_phase(res, dev)
    ritz_row["launches"] += part_launches["sym_eig_jacobi"]
    table.append(ritz_row)
    argmin_row["partition_launches"] = part_launches["fused_argmin"]
    sparse_launches = {n: c4_launches[n] + part_launches[n]
                       for n in ("csr_spmv", "csr_spmm")}
    table += sparse_numbers(g, x, b16, sparse_launches, {
        n: max(parity_errs[n], c4["max_abs_err"][n], part_errs[n])
        for n in sparse_launches})
    operator_overhead(g, x)
    del x, b16
    torch.cuda.empty_cache()
    _, mst_plan, mst_launches, mst_out = mst_phase(res, dev)
    table.append(mst_numbers(mst_plan, mst_launches,
                             mst_out["per_round_kernel_alone_ms"]))
    torch.cuda.empty_cache()
    c2_launches, c2_err, c2_keyed_row = config2_phase(res, dev)
    spmm_row = next(r for r in table if r["name"] == "csr_spmm")
    spmm_row["config2_launches"] = c2_launches["csr_spmm"]
    spmm_row["launches"] += c2_launches["csr_spmm"]
    spmm_row["max_abs_err"] = max(spmm_row["max_abs_err"], c2_err)
    spmm_row["keyed_shape"] = c2_keyed_row
    ivf, ivf_launches, ivf_argmin, ivf_lloyd = ivf_phase(res, dev)
    db = KEPT.pop("knn_db")
    serve_launches = serve_phase(res, dev, db)
    fleet_launches = serve_fleet_phase(res, dev, db, KEPT.get("ivf_flat"))
    del db
    KEPT.clear()
    torch.cuda.empty_cache()
    stream_launches = streaming_phase(res, dev)
    for row in table:
        if stream_launches.get(row["name"], 0):
            row["streaming_launches"] = stream_launches[row["name"]]
            row["launches"] += stream_launches[row["name"]]
        if serve_launches.get(row["name"], 0):
            row["serve_launches"] = serve_launches[row["name"]]
            row["launches"] += serve_launches[row["name"]]
        if fleet_launches.get(row["name"], 0):
            row["serve_fleet_launches"] = fleet_launches[row["name"]]
            row["launches"] += fleet_launches[row["name"]]
    aot_phase(res, dev)
    (c5_launches, model_launches, c5_plain, mnmg_launches, mnmg_errs,
     ivf["mnmg"], ivf_mnmg_launches) = comms_mnmg_phase(res, dev, g)
    torch.cuda.empty_cache()
    sc_launches = sparse_compat_phase(res, dev, g, smi)
    del g
    for row in table:
        if sc_launches.get(row["name"], 0):
            row["sparse_compat_launches"] = sc_launches[row["name"]]
            row["launches"] += sc_launches[row["name"]]
    for name, c in ivf_mnmg_launches.items():
        ivf_launches[name] = ivf_launches.get(name, 0) + c
    ivf["launches"] = ivf_launches
    emit("ivf", **ivf)
    for row in table:
        if ivf_launches.get(row["name"], 0):
            row["ivf_launches"] = ivf_launches[row["name"]]
            row["launches"] += ivf_launches[row["name"]]
    for name, shape in (("fused_argmin", ivf_argmin),
                        ("fused_lloyd", ivf_lloyd)):
        row = next(r for r in table if r["name"] == name)
        row["ivf_pq_shape"] = shape
        row["max_abs_err"] = max(row["max_abs_err"], shape["max_abs_err"])
    lloyd_row = next(r for r in table if r["name"] == "fused_lloyd")
    lloyd_row["config5_shape"] = [C5_M, C5_K, C5_D]
    lloyd_row["config5_max_abs_err"] = max(c5_plain["sample_max_abs_err"],
                                           c5_plain["sums_max_abs_err"])
    for row in table:
        extra = (c5_launches.get(row["name"], 0)
                 + model_launches.get(row["name"], 0))
        if extra:
            row["comms_mnmg_launches"] = extra
            row["launches"] += extra
        if mnmg_launches.get(row["name"], 0):
            row["mnmg_fit_launches"] = mnmg_launches[row["name"]]
            row["launches"] += mnmg_launches[row["name"]]
        if row["name"] in mnmg_errs:
            row["mnmg_fit_max_abs_err"] = mnmg_errs[row["name"]]
            row["max_abs_err"] = max(row["max_abs_err"],
                                     mnmg_errs[row["name"]])
    stats_launches, stats_parity = stats_phase(res, dev)
    for row in table:
        if stats_launches.get(row["name"], 0):
            row["stats_launches"] = stats_launches[row["name"]]
            row["launches"] += stats_launches[row["name"]]
    for name, parts in (("unexpanded_tile", ("silhouette_distances",
                                             "trust_embedded_distances",
                                             "trust_original_distances")),
                        ("csr_spmm", ("silhouette_keyed_sums",)),
                        ("topk_insert", ("trust_topk",))):
        row = next(r for r in table if r["name"] == name)
        row["stats_shapes"] = {p: stats_parity[p] for p in parts}
        row["max_abs_err"] = max([row["max_abs_err"]]
                                 + [stats_parity[p]["max_abs_err"]
                                    for p in parts])
    primitives_phase(res, dev)
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
