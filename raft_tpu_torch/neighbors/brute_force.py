"""Brute-force k-NN on one device (counterpart of
``raft_tpu/neighbors/brute_force.py``).

:func:`knn_plan` is the single dispatch predictor, the reference's, and
:func:`knn` routes through it:

- ``"fused"`` (k <= 256, metric l2/cosine/inner): the fused distance +
  top-k kernel (``csrc/fused_topk.cu``), no distance matrix;
- ``"radix"`` (larger k on long databases, and every k of the
  unexpanded metrics there): per database chunk one ``(q, chunk)``
  distance block (``csrc/pairwise_tile.cu``, or ``csrc/unexpanded_tile.cu``
  for ``l1``/``linf``/``canberra``), its radix top-k
  (``csrc/radix_threshold.cu`` + ``csrc/radix_emit.cu``), and a merge
  into the running best;
- ``"scan"`` otherwise: the same per tile with the stable key sort of
  ``lax.top_k``'s order in place of the radix select.

:func:`knn_mnmg` is the multi-rank search over ``raft_tpu_torch.comms``:
database rows sharded over the ranks, queries replicated, one
all-gather of the ranks' candidates and a merge.

Not ported yet: ``knn``'s work-budget admission (queue A item 13b; the
budget of ``runtime.limits`` is ported, but ``knn`` does not consult it,
so its dispatch is the reference's with no budget active) and the
dispatch trace event (obs, queue A item 13b).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.operators import exact_sqrt
from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.linalg import contractions as tc
from raft_tpu_torch.matrix import _topk_order, radix_select
from raft_tpu_torch.matrix.epilogue import masked_topk
from raft_tpu_torch.neighbors import fused_topk
from raft_tpu_torch.util.math import round_up_to_multiple
from raft_tpu_torch.util.precision import current_mode, with_matmul_precision

_METRIC_ALIASES = {"l2": "l2", "sqeuclidean": "l2", "euclidean": "l2",
                   "cosine": "cosine", "inner": "inner",
                   "l1": "l1", "manhattan": "l1", "cityblock": "l1",
                   "linf": "linf", "chebyshev": "linf",
                   "canberra": "canberra"}

_UNEXPANDED = ("l1", "linf", "canberra")


def _resolve_metric(metric: str) -> str:
    kernel_metric = _METRIC_ALIASES.get(metric)
    if kernel_metric is None:
        raise ValueError(f"unknown metric {metric!r}")
    return kernel_metric


def _validate(db, queries, k: int) -> None:
    if db.dim() != 2 or queries.dim() != 2 or db.shape[1] != queries.shape[1]:
        raise ValueError(
            f"shape mismatch: db {tuple(db.shape)} vs queries "
            f"{tuple(queries.shape)}")
    if not 0 < k <= db.shape[0]:
        raise ValueError(f"need 0 < k <= n_db, got k={k}, n={db.shape[0]}")


def _finalize(vals, metric: str):
    if metric == "euclidean":
        return exact_sqrt(torch.clamp_min(vals, 0.0))
    if metric in ("l2", "sqeuclidean"):
        return torch.clamp_min(vals, 0.0)
    if metric == "inner":
        return -vals                   # back to similarity, desc order
    return vals


def _clamp_tile(tile: int, k: int, n: int) -> int:
    """Tile width: lane-aligned, no wider than the (padded) database, and
    never below k."""
    t = min(round_up_to_multiple(tile, 128), round_up_to_multiple(n, 128))
    return max(t, round_up_to_multiple(k, 128))


def _distance_blocks(queries, db, width: int, metric: str):
    """``(offset, (q, width) distance block)`` over the database in
    column blocks of ``width``, one pairwise-tile launch each (one
    unexpanded-tile launch for ``l1``/``linf``/``canberra``); a short
    last block is padded with +inf (the reference masks its padded
    database rows to +inf)."""
    tier = current_mode()
    q, d = queries.shape
    n = db.shape[0]
    unexpanded = metric in _UNEXPANDED
    xs = None if unexpanded else tc._side(queries, tier)
    for off in range(0, n, width):
        w = min(width, n - off)
        block = db[off:off + w].contiguous()
        if unexpanded:
            dist = tc._unexpanded_tile(metric, 2.0, queries, block)
        else:
            dist = tc._pairwise_tile(tier, metric, xs, tc._side(block, tier),
                                     q, w, d)
        if w < width:
            dist = torch.nn.functional.pad(dist, (0, width - w),
                                           value=float("inf"))
        yield off, dist


def _merge(best_v, best_i, tv, ti, k: int):
    """Running best of ``[best | tile]`` in ``lax.top_k``'s order (the
    best entries first among equal values)."""
    pool_v = torch.cat([best_v, tv], dim=1)
    pool_i = torch.cat([best_i, ti], dim=1)
    mv, mp = _topk_order.topk(pool_v, k, largest=False)
    return mv, torch.gather(pool_i, 1, mp)


def _init_best(q: int, k: int, device):
    return (torch.full((q, k), float("inf"), device=device),
            torch.zeros((q, k), dtype=torch.int64, device=device))


def _knn_scan(queries, db, k: int, tile: int, metric: str,
              n_valid: Optional[int] = None):
    """Running top-k over database column tiles. ``n_valid`` (default:
    every row) masks the trailing rows from ``n_valid`` on to +inf, as
    the reference masks a shard's pad rows."""
    best_v, best_i = _init_best(queries.shape[0], k, queries.device)
    for off, dist in _distance_blocks(queries, db, tile, metric):
        if n_valid is not None and off + dist.shape[1] > n_valid:
            dist = dist.clone()
            dist[:, max(n_valid - off, 0):] = float("inf")
        tv, tp = masked_topk(dist, None, k, use_radix=False)
        best_v, best_i = _merge(best_v, best_i, tv, tp + off, k)
    return best_v, best_i.to(torch.int32)


def _chunk_for(q: int, n: int, k: int, tile_cap: int = 0) -> int:
    """Database chunk width for the radix path (the reference's rule):
    large enough that the per-chunk radix select amortizes, small enough
    that the (q, chunk) f32 block stays under 512 MiB; 0 when the radix
    path should not run."""
    floor = radix_select.MIN_COLS
    cap = (512 << 20) // max(q * 4, 1)
    cap -= cap % 128
    if tile_cap:
        cap = min(cap, tile_cap)
    if cap < floor:
        return 0
    chunk = min(round_up_to_multiple(n, 128), 1 << 20, cap)
    if n < 2 * floor or not radix_select.preferred(chunk, k):
        return 0
    if not radix_select.supports(torch.float32, chunk, k):
        return 0
    return chunk


def _knn_chunked(queries, db, k: int, chunk: int, metric: str):
    """Chunked radix formulation: a (q, chunk) distance block per step,
    its radix top-k, then one (q, 2k) merge into the running best."""
    best_v, best_i = _init_best(queries.shape[0], k, queries.device)
    for off, dist in _distance_blocks(queries, db, chunk, metric):
        tv, tp = masked_topk(dist, None, k, use_radix=True)
        best_v, best_i = _merge(best_v, best_i, tv, tp + off, k)
    return best_v, best_i.to(torch.int32)


@with_matmul_precision
def knn(res, db, queries, k: int, metric: str = "l2",
        tile: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest database rows per query: ``(distances [q, k] f32,
    indices [q, k] int32)``, nearest first.

    ``metric``: 'l2' (squared L2), 'sqeuclidean' (alias), 'euclidean'
    (rooted), 'cosine', 'inner' (largest inner product first), 'l1'
    ('manhattan', 'cityblock'), 'linf' ('chebyshev') or 'canberra'.
    ``tile``: explicit working-block width, also a memory bound on the
    chunked path's distance block. A non-tensor input goes to ``res``'s
    device (``cuda:0`` by default). Dispatch: :func:`knn_plan`."""
    db = as_tensor(db, res)
    queries = as_tensor(queries, res)
    _validate(db, queries, k)
    kernel_metric = _resolve_metric(metric)
    path, chunk = knn_plan(queries.shape[0], db.shape[0], k, metric=metric,
                           tile=tile)
    queries = queries.to(torch.float32).contiguous()
    db = db.to(torch.float32).contiguous()
    if path == "fused":
        vals, idx = fused_topk.knn_fused(queries, db, k, kernel_metric,
                                         tn=min(tile or 1024, 1024))
        return _finalize(vals, metric), idx
    if path == "radix":
        vals, idx = _knn_chunked(queries, db, k, chunk, kernel_metric)
    else:
        tile_w = _clamp_tile(tile or 8192, k, db.shape[0])
        vals, idx = _knn_scan(queries, db, k, tile_w, kernel_metric)
    return _finalize(vals, metric), idx


def knn_plan(n_queries: int, n_db: int, k: int, metric: str = "l2",
             tile: Optional[int] = None, vma_blocked: bool = False,
             n_lists: Optional[int] = None, nprobe: Optional[int] = None,
             pq: bool = False) -> Tuple[str, int]:
    """Pure dispatch predictor for :func:`knn`: ``("ivf" | "ivf_pq" |
    "fused" | "radix" | "scan", chunk)``, the reference's answer for
    every input. ``vma_blocked`` (the reference's interpreter replay
    limit) and the IVF arguments keep the reference's signature."""
    kernel_metric = _resolve_metric(metric)
    if n_lists is not None and nprobe is not None and nprobe < n_lists:
        return ("ivf_pq" if pq else "ivf"), 0
    if (fused_topk.supports(k) and (tile is None or tile >= 128)
            and kernel_metric in ("l2", "cosine", "inner")
            and not vma_blocked):
        return "fused", 0
    chunk = _chunk_for(n_queries, n_db, k, tile_cap=tile or 0)
    if chunk and not vma_blocked:
        return "radix", chunk
    return "scan", 0


# the l2 pad rows' coordinate: their squared distances (about 1e30 · d)
# are finite and larger than any real candidate's, so they never survive
# a merge that has k real candidates in its pool
_PAD_SENTINEL = 1e15


@with_matmul_precision
def knn_mnmg(res, db, queries, k: int, metric: str = "l2",
             tile: Optional[int] = None, mesh=None,
             data_axis: str = "data") -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-rank brute-force k-NN: ``(distances [q, k], indices [q, k])``
    in global database row numbering, the same on every rank.

    One process a rank: every rank of ``mesh`` (a ``DeviceMesh``; by
    default the handle's) calls this with the same global ``db`` and
    ``queries``. Rank r searches rows ``[r·per, (r+1)·per)``, ``per =
    ceil(n / ranks)`` (the last shard short, or empty), keeping its own
    top k: l2 with :func:`fused_topk.supports` through the fused top-k
    kernel (``csrc/fused_topk.cu``), a short shard padded with rows at
    ``1e15`` that never rank in; the other metrics through the scan
    with the shard's row count masking its pad. One all-gather of the
    ranks' ``k`` candidates follows, and a merge in ``lax.top_k``'s
    order: equal distances go to the lower pool position, the lower
    rank. When ``k > per`` no shard holds k rows and the search runs on
    one device (:func:`knn`), as in the reference."""
    from raft_tpu_torch.comms import device as dev
    from raft_tpu_torch.core import resources as core_res

    db = as_tensor(db, res)
    queries = as_tensor(queries, res)
    _validate(db, queries, k)
    kernel_metric = _resolve_metric(metric)
    if mesh is None:
        mesh = core_res.get_mesh(core_res.default_resources(res))
    with dev.mesh_scope(mesh):
        ndev = dev.size(data_axis)
    n = db.shape[0]
    per = -(-n // ndev)
    if k > per:
        return knn(res, db, queries, k, metric=metric, tile=tile)
    use_fused = (fused_topk.supports(k) and kernel_metric == "l2"
                 and (tile is None or tile >= 128))
    queries = queries.to(torch.float32).contiguous()
    db = db.to(torch.float32)
    with dev.mesh_scope(mesh):
        start = dev.rank(data_axis) * per
        shard = db[start:start + per]
        n_local = shard.shape[0]
        if n_local < per:
            pad = _PAD_SENTINEL if use_fused else 0.0
            shard = torch.cat([shard, torch.full(
                (per - n_local, db.shape[1]), pad, dtype=db.dtype,
                device=db.device)])
        shard = shard.contiguous()
        if use_fused:
            v, i = fused_topk.knn_fused(queries, shard, k, kernel_metric,
                                        tn=min(tile or 1024, 1024))
        else:
            v, i = _knn_scan(queries, shard, k,
                             _clamp_tile(tile or 8192, k, per),
                             kernel_metric, n_valid=n_local)
        i = i.to(torch.int32) + start
        all_v = dev.allgather(v, axis_name=data_axis)      # [ranks, q, k]
        all_i = dev.allgather(i, axis_name=data_axis)
    q = queries.shape[0]
    pool_v = all_v.transpose(0, 1).reshape(q, ndev * k)
    pool_i = all_i.transpose(0, 1).reshape(q, ndev * k)
    mv, mp = _topk_order.topk(pool_v, k, largest=False)
    return _finalize(mv, metric), torch.gather(pool_i, 1, mp)
