"""Sharded IVF-Flat over the ranks of a mesh (counterpart of
``raft_tpu/neighbors/ivf_mnmg.py``).

One process a rank, as ``knn_mnmg``. :func:`build_mnmg` partitions the
inverted lists of an :class:`~raft_tpu_torch.neighbors.ivf_flat.IvfFlatIndex`
over ``n_ranks`` shards by a deterministic longest-processing-time
assignment of whole lists (:func:`partition_lists`). Every rank holds
the flat index as a host mirror (CPU tensors) and the list owners, and
carves every rank's shard on the host (pure numpy): a dense
``[cap_rank_max, d]`` packed block (its lists back to back, each list's
slots in the flat order) and full ``[n_lists]`` span tables in which the
lists it does not own have size 0, so ``take_rows``'s valid mask erases
them. Only its own shard, and the centroids, are on its device;
:meth:`IvfMnmgIndex.shard` still gives any rank's operand set.

:func:`search_mnmg` runs the single-rank probe scan
(``ivf_flat._probe_topk``: the coarse probe, the span gather, the fine
distances and the radix or key-sort select) on the local shard,
all-gathers the ``[q, k]`` raw keys and ids over the mesh axis
(``comms.device.allgather``), merges the ``[q, n_ranks * k]`` pool in
rank-major order (:func:`_merge_body`, ``lax.top_k``'s order) and
finalizes once. ``nprobe >= n_lists`` delegates to ``knn`` on the
reconstructed database, as ``ivf_flat.search`` does. :func:`search_local`
and :func:`merge_pool` are the two halves, for a clique that exchanges
the pool over its host mailbox instead.

An index built without a mesh is carved on the host only: its shards,
shrink, rebalance and the full probe work, and a partial search raises
until it is repacked with a mesh (the reference makes a default mesh of
the first ``n_ranks`` devices; one process here drives one rank).
The reference donates the query buffer to its compiled program; eager
PyTorch has no counterpart, and the port copies nothing it would donate.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import trace
from raft_tpu_torch.core.resources import as_tensor
from raft_tpu_torch.matrix import _topk_order
from raft_tpu_torch.neighbors.ivf_flat import (IvfFlatIndex, _admitted,
                                               _probe_topk, _resolve_metric,
                                               _use_radix, _validate_search,
                                               build as build_flat)
from raft_tpu_torch.util.precision import with_matmul_precision

__all__ = ["IvfMnmgIndex", "build_mnmg", "search_mnmg", "shrink_mnmg",
           "rebalance_mnmg", "partition_lists", "search_local",
           "merge_pool", "DEFAULT_AXIS"]

#: mesh axis name the sharded index lives on (distinct from the solvers'
#: "data", so a serving mesh can sit beside a compute mesh)
DEFAULT_AXIS = "shard"


def partition_lists(caps, n_ranks: int) -> np.ndarray:
    """Deterministic list -> rank assignment: longest-processing-time
    greedy over padded list capacities (largest list first, ties by
    ascending list id, each on the least-loaded rank, ties by lowest
    rank). A pure function of ``(caps, n_ranks)``."""
    caps = np.asarray(caps, np.int64)
    if n_ranks < 1:
        raise ValueError(f"need n_ranks >= 1, got {n_ranks}")
    owner = np.empty(len(caps), np.int32)
    load = np.zeros(n_ranks, np.int64)
    for lst in sorted(range(len(caps)), key=lambda i: (-caps[i], i)):
        r = int(np.argmin(load))              # first occurrence = lowest
        owner[lst] = r
        load[r] += caps[lst]
    return owner


@dataclasses.dataclass
class IvfMnmgIndex:
    """Sharded IVF-Flat index: every rank's shard carved on the host, the
    flat index they were carved from (a host mirror), and this rank's
    shard on its device.

    The stacked host arrays have the rank as leading dim;
    ``starts_sh``/``sizes_sh`` are local span tables over the global
    list ids, size 0 where a rank does not own the list. ``rank`` is this
    process's position on ``axis`` of ``mesh`` (None without a mesh);
    ``local`` its device operands ``(centroids, packed_db, packed_ids,
    starts, sizes)`` on ``device``."""

    flat: IvfFlatIndex
    owner: np.ndarray               # [n_lists] host int32, list -> rank
    packed_db_sh: np.ndarray        # [R, cap_rank_max, d] original dtype
    packed_ids_sh: np.ndarray       # [R, cap_rank_max] int32, -1 = pad
    starts_sh: np.ndarray           # [R, n_lists] int32 local starts
    sizes_sh: np.ndarray            # [R, n_lists] int32, 0 = not owned
    cap_rank_max: int               # packed rows a rank
    mesh: object = dataclasses.field(repr=False, compare=False,
                                     default=None)
    axis: str = DEFAULT_AXIS
    device: torch.device = dataclasses.field(
        default=torch.device("cpu"), compare=False)
    rank: Optional[int] = None
    local: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                               compare=False)
    _db_cache: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def n_ranks(self) -> int:
        return int(self.packed_db_sh.shape[0])

    @property
    def n_lists(self) -> int:
        return self.flat.n_lists

    @property
    def dim(self) -> int:
        return self.flat.dim

    @property
    def metric(self) -> str:
        return self.flat.metric

    @property
    def cap_max(self) -> int:
        return self.flat.cap_max

    @property
    def n_db(self) -> int:
        return self.flat.n_db

    def scanned_fraction(self, nprobe: int) -> float:
        return self.flat.scanned_fraction(nprobe)

    def reconstruct(self) -> torch.Tensor:
        """The database in original row order, bit-exact, on the host
        (the flat mirror's; packing never rewrites a row)."""
        return self.flat.reconstruct()

    def _reconstructed_on(self, device) -> torch.Tensor:
        """:meth:`reconstruct` copied to ``device`` once and cached (the
        full probe's operand)."""
        if self._db_cache is None or self._db_cache.device != device:
            self._db_cache = self.reconstruct().to(device)
        return self._db_cache

    def shard(self, rank: int) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]:
        """One rank's ``(packed_db, packed_ids, starts, sizes)`` on this
        index's device: this rank's resident shard, another's copied from
        the host."""
        if rank == self.rank and self.local is not None:
            return self.local[1:]
        return tuple(torch.from_numpy(a[rank]).to(self.device)
                     for a in (self.packed_db_sh, self.packed_ids_sh,
                               self.starts_sh, self.sizes_sh))


def _host_flat(flat: IvfFlatIndex) -> IvfFlatIndex:
    """The flat index with its tensors on the host (the mirror every
    rank keeps)."""
    cpu = torch.device("cpu")
    return dataclasses.replace(
        flat, centroids=flat.centroids.to(cpu),
        packed_db=flat.packed_db.to(cpu), packed_ids=flat.packed_ids.to(cpu),
        starts=flat.starts.to(cpu), sizes=flat.sizes.to(cpu), _db_cache=None)


def _shard_arrays(flat: IvfFlatIndex, owner: np.ndarray, n_ranks: int):
    """Carve the flat index's packed arrays into rank-stacked shards on
    the host (pure numpy)."""
    caps = np.asarray(flat.caps, np.int64)
    gstarts = flat.starts.numpy().astype(np.int64)
    sizes = flat.sizes.numpy().astype(np.int64)
    db_np = flat.packed_db.numpy()
    ids_np = flat.packed_ids.numpy()
    n_lists = flat.n_lists
    cap_rank = np.asarray([int(caps[owner == r].sum())
                           for r in range(n_ranks)], np.int64)
    cap_rank_max = max(int(cap_rank.max(initial=0)), 1)
    db_sh = np.zeros((n_ranks, cap_rank_max, flat.dim), db_np.dtype)
    ids_sh = np.full((n_ranks, cap_rank_max), -1, np.int32)
    starts_sh = np.zeros((n_ranks, n_lists), np.int32)
    sizes_sh = np.zeros((n_ranks, n_lists), np.int32)
    for r in range(n_ranks):
        at = 0
        for lst in np.flatnonzero(owner == r):
            c = int(caps[lst])
            g = int(gstarts[lst])
            db_sh[r, at:at + c] = db_np[g:g + c]
            ids_sh[r, at:at + c] = ids_np[g:g + c]
            starts_sh[r, lst] = at
            sizes_sh[r, lst] = sizes[lst]
            at += c
    return db_sh, ids_sh, starts_sh, sizes_sh, cap_rank_max


def _from_flat(flat: IvfFlatIndex, n_ranks: int, *, mesh=None,
               axis: str = DEFAULT_AXIS,
               device: Optional[torch.device] = None) -> IvfMnmgIndex:
    """Partition, carve and place: the one path of :func:`build_mnmg`,
    :func:`shrink_mnmg` and :func:`rebalance_mnmg`, so a repack is a
    fresh build on its rank count."""
    from raft_tpu_torch.comms import device as dev

    device = flat.centroids.device if device is None else device
    rank = None
    if mesh is not None:
        with dev.mesh_scope(mesh):
            if dev.size(axis) != n_ranks:
                raise ValueError(f"mesh axis {axis!r} has {dev.size(axis)} "
                                 f"ranks, need n_ranks={n_ranks}")
            rank = dev.rank(axis)
    flat = _host_flat(flat)
    owner = partition_lists(flat.caps, n_ranks)
    db_sh, ids_sh, starts_sh, sizes_sh, cap_rank_max = _shard_arrays(
        flat, owner, n_ranks)
    local = None
    if rank is not None:
        local = (flat.centroids.to(device),) + tuple(
            torch.from_numpy(a[rank]).to(device)
            for a in (db_sh, ids_sh, starts_sh, sizes_sh))
    return IvfMnmgIndex(
        flat=flat, owner=owner, packed_db_sh=db_sh, packed_ids_sh=ids_sh,
        starts_sh=starts_sh, sizes_sh=sizes_sh, cap_rank_max=cap_rank_max,
        mesh=mesh, axis=axis, device=device, rank=rank, local=local)


def build_mnmg(res, db, n_lists: int, n_ranks: int,
               metric: str = "l2", *, mesh=None,
               axis: str = DEFAULT_AXIS, max_iter: int = 25,
               seed: int = 0, centroids=None,
               flat: Optional[IvfFlatIndex] = None) -> IvfMnmgIndex:
    """Train (or adopt) a flat IVF index and partition its inverted lists
    over ``n_ranks`` shards; every rank calls it alike.

    ``flat`` shards an already-built index without retraining; otherwise
    the quantizer trains as :func:`raft_tpu_torch.neighbors.ivf_flat.build`
    does. ``mesh`` is a ``DeviceMesh`` with an axis ``axis`` of
    ``n_ranks`` ranks (``ValueError`` otherwise; without one the index is
    host-only). This rank's shard goes to the flat index's device. The partition is
    deterministic: two builds from one flat index at one rank count
    carve the same shards."""
    if flat is None:
        flat = build_flat(res, db, n_lists, metric, max_iter=max_iter,
                          seed=seed, centroids=centroids)
    else:
        _resolve_metric(flat.metric)
    return _from_flat(flat, n_ranks, mesh=mesh, axis=axis)


def shrink_mnmg(index: IvfMnmgIndex, survivors: Sequence[int], *,
                mesh=None) -> IvfMnmgIndex:
    """Repack for the survivors after a rank's death, from the host flat
    mirror: bitwise ``build_mnmg(flat=index.flat,
    n_ranks=len(survivors))`` (:func:`partition_lists` is pure). ``mesh``
    is the survivors' mesh; without one the repack is host-only."""
    n_ranks = len(set(int(r) for r in survivors))
    if n_ranks < 1:
        raise ValueError("need at least one survivor")
    return _from_flat(index.flat, n_ranks, mesh=mesh, axis=index.axis,
                      device=index.device)


def rebalance_mnmg(index: IvfMnmgIndex, *,
                   flat: Optional[IvfFlatIndex] = None,
                   mesh=None) -> IvfMnmgIndex:
    """Repack the current (or a given, mutated) flat index over the same
    rank count: :func:`partition_lists` re-runs on the current caps, as a
    fresh build would place them. ``mesh`` defaults to the index's."""
    return _from_flat(index.flat if flat is None else flat, index.n_ranks,
                      mesh=index.mesh if mesh is None else mesh,
                      axis=index.axis, device=index.device)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def _merge_body(pool_v, pool_i, *, k: int, metric: str,
                use_radix: bool):
    """The select over the gathered ``[q, R * k]`` raw-key pool and the
    one metric finalize."""
    from raft_tpu_torch.neighbors.brute_force import _finalize

    if use_radix:
        from raft_tpu_torch.matrix.radix_select import radix_select_k

        vals, pos = radix_select_k(pool_v, k)
    else:
        vals, pos = _topk_order.topk(pool_v, k, largest=False)
    out_ids = torch.gather(pool_i, 1, pos)
    out_ids = torch.where(torch.isfinite(vals), out_ids,
                          torch.full_like(out_ids, -1))
    return _finalize(vals, metric), out_ids


def _pool(vals_stack, ids_stack):
    """``[R, q, k]`` stacks -> ``[q, R * k]`` pools, rank-major."""
    r, q, kk = vals_stack.shape
    return (vals_stack.transpose(0, 1).reshape(q, r * kk),
            ids_stack.transpose(0, 1).reshape(q, r * kk))


@with_matmul_precision
def search_mnmg(res, index: IvfMnmgIndex, queries, k: int, nprobe: int,
                *, tomb_words=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest database rows per query over the sharded index, the
    same ``(distances [q, k], indices [q, k])`` on every rank, in global
    row numbering, nearest first, padded with -1 / +inf as
    :func:`raft_tpu_torch.neighbors.ivf_flat.search`. Every rank calls it
    with the same queries.

    ``nprobe >= n_lists`` delegates to ``knn`` on the reconstructed
    database (bitwise the single-rank full probe). A partial probe scans
    the local shard, all-gathers each rank's k candidates and merges;
    each candidate's distance has the bits it has in the single-rank
    search. ``tomb_words``: packed tombstones over global ids, partial
    probes only.

    With a ``runtime.limits`` budget active, an over-budget launch runs
    in query-row chunks (the same on every rank, the same bits) or
    raises ``RejectedError``."""
    from raft_tpu_torch.comms import device as dev
    from raft_tpu_torch.runtime import limits

    queries = as_tensor(queries, res)
    _validate_search(index, queries, k, nprobe)
    metric = index.metric
    if nprobe >= index.n_lists:
        if tomb_words is not None:
            raise ValueError(
                "tomb_words is only supported on the partial-probe "
                "path; the exact path brute-forces the live rows")
        from raft_tpu_torch.neighbors.brute_force import knn

        trace.record_event("ivf_mnmg.search", nprobe=index.n_lists,
                           n_lists=index.n_lists, k=k,
                           n_ranks=index.n_ranks, scanned_frac=1.0,
                           path="exact")
        return knn(res, index._reconstructed_on(queries.device), queries,
                   k, metric=metric)
    if index.local is None:
        raise ValueError("this index was carved without a mesh; repack it "
                         "with shrink_mnmg or rebalance_mnmg and mesh=")
    probe_rows = nprobe * index.cap_max
    if probe_rows < k:
        raise ValueError(
            f"nprobe={nprobe} reaches at most {probe_rows} candidates "
            f"< k={k}; raise nprobe (>= n_lists scans exactly)")
    trace.record_event("ivf_mnmg.search", nprobe=nprobe,
                       n_lists=index.n_lists, k=k,
                       n_ranks=index.n_ranks,
                       scanned_frac=round(
                           index.scanned_fraction(nprobe), 4),
                       path="ivf_mnmg")
    use_radix = _use_radix(probe_rows, k)
    use_radix_merge = _use_radix(index.n_ranks * k, k)
    tomb = None if tomb_words is None else \
        torch.as_tensor(tomb_words).to(index.device)

    def launch(qrows):
        vals, ids = _probe_topk(
            qrows, *index.local, k=k, nprobe=nprobe, cap_max=index.cap_max,
            metric=metric, use_radix=use_radix, tomb_words=tomb)
        with dev.mesh_scope(index.mesh):
            pool = _pool(dev.allgather(vals, axis_name=index.axis),
                         dev.allgather(ids, axis_name=index.axis))
        return _merge_body(*pool, k=k, metric=metric,
                           use_radix=use_radix_merge)

    if limits.active_budget() is None:
        return launch(queries)
    op = "neighbors.ivf_mnmg_search"
    itemsize = index.packed_db_sh.dtype.itemsize
    dims = dict(probe_rows=probe_rows, n_dims=index.dim, k=k,
                n_ranks=index.n_ranks, itemsize=itemsize)
    return _admitted(
        op, launch, queries,
        per_row=limits.estimate_bytes(op, n_queries=1, **dims),
        fixed_bytes=index.cap_rank_max * (index.dim * itemsize + 4),
        detail="even a single query row's per-rank candidate tile "
               "overflows the budget")


# ---------------------------------------------------------------------------
# the two halves, for a clique that exchanges the pool on the host
# ---------------------------------------------------------------------------


def search_local(index: IvfMnmgIndex, rank: int, queries, k: int,
                 nprobe: int, *, tomb_words=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's half of the sharded search, no collective: raw
    ascending keys ``[q, k]`` and global ids ``[q, k]`` from ``rank``'s
    shard alone (+inf / -1 where it has fewer than k reachable
    candidates), computed as :func:`search_mnmg` computes them.
    ``tomb_words``: packed tombstones over global ids, as there."""
    queries = torch.as_tensor(queries, device=index.device)
    centroids = (index.local[0] if index.local is not None
                 else index.flat.centroids.to(index.device))
    tomb = None if tomb_words is None else \
        torch.as_tensor(tomb_words).to(index.device)
    return _probe_topk(queries, centroids, *index.shard(rank), k=k,
                       nprobe=nprobe, cap_max=index.cap_max,
                       metric=index.metric,
                       use_radix=_use_radix(nprobe * index.cap_max, k),
                       tomb_words=tomb)


def merge_pool(vals_stack, ids_stack, k: int, metric: str
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge rank-stacked pools ``[R, q, k]`` (raw keys from
    :func:`search_local`, rank-major) into the final ``(distances,
    ids)``: the select and finalize :func:`search_mnmg` runs after its
    all-gather, so both agree bit for bit for one rank order. Tensors
    stay on their device; other arrays go to ``cuda:0``."""
    vals_stack = as_tensor(vals_stack)
    ids_stack = torch.as_tensor(ids_stack, device=vals_stack.device)
    r, _, kk = vals_stack.shape
    return _merge_body(*_pool(vals_stack, ids_stack), k=k, metric=metric,
                       use_radix=_use_radix(r * kk, k))
