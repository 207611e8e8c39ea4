"""Streaming IVF-Flat index: journaled mutation, compaction without a
serving pause, and a drift-triggered refit (counterpart of
``raft_tpu/neighbors/streaming.py``).

The batch IVF-Flat index (:mod:`raft_tpu_torch.neighbors.ivf_flat`)
becomes a mutable, servable object:

- **insert** fills the padded list tails in place when the rows fit (every
  tensor keeps its shape, so a warmed serving program stays valid); an
  overflowing tail repacks every live row under a new epoch.
- **delete** sets a bit in a packed uint32 tombstone set over global row
  ids. The words mask the probe scan's candidates
  (``ivf_flat._probe_topk``'s ``tomb_words``), and their shape is fixed
  for an epoch.
- **journal**: every mutation is written to a write-ahead log (v1
  checkpoint containers of :mod:`raft_tpu_torch.core.checkpoint`,
  CRC-checked, atomically renamed) before it is applied, so a killed
  process replays to the same index. The files are the reference
  package's byte for byte: each package recovers the other's directory.
- **compaction** (:class:`Compactor`): live rows repack into fresh
  tensors off the mutation lock, then a short commit writes the epoch
  file, prunes the folded WAL and swaps the serving snapshot.
- **drift and refit** (:class:`DriftGauge`): an EMA of ingested rows'
  nearest-centroid distance against the build-time baseline; past
  ``RAFT_TPU_DRIFT_THRESHOLD`` a ``kmeans_partial_fit`` on the recent rows
  moves the centroids and the index repacks under them.

Row ids are given at insert in arrival order and never renumbered. The
witness of a recovery is :meth:`StreamingIndex.content_crc`, a CRC over
ids, rows in id order and centroids, independent of the packing.

Device work: the packed tensors, the tombstone words a snapshot carries
and the repack stay on the index's device (that of ``res``; ``cuda:0``
by default, which raises without CUDA). The list-slot arithmetic, the
tombstone set being mutated and the journal are on the host. A
published snapshot is never written again: a fitting insert writes a
device copy of the packed tensors (``clone`` and ``index_copy_``), and a
delete publishes a copy of the host words, so a search or a served batch
that holds an older snapshot keeps its bits. Searches never take the
mutation lock; they read one snapshot attribute. Every device operation
runs on the calling thread's current stream, the default stream unless
the caller chose another, so a publish is ordered after the writes it
publishes for every reader on that stream.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import re
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import env, trace
from raft_tpu_torch.core.bitset import WORD_BITS
from raft_tpu_torch.core.checkpoint import (CheckpointError, CheckpointManager,
                                            load_checkpoint, save_checkpoint)
from raft_tpu_torch.core.resources import default_resources, get_device
from raft_tpu_torch.neighbors.ivf_flat import (SLOT_ALIGN, IvfFlatIndex,
                                               _append_slots, _coarse_labels,
                                               _pack, _resolve_metric,
                                               _search_body, _use_radix, build)
from raft_tpu_torch.util import precision

__all__ = [
    "StreamingError", "RecoveryError", "WalGapError",
    "ShardCorruptError", "TermFencedError", "MutationLog", "DriftGauge",
    "StreamingIndex", "Compactor", "StreamingMnmg", "stream_build",
    "KIND_INSERT", "KIND_DELETE", "KIND_CENTROIDS", "KIND_TERM",
]

#: WAL record kinds (checkpoint entries carry scalars, not strings)
KIND_INSERT = 0
KIND_DELETE = 1
#: a refit's new centroids: a content change (they are in the CRC), so
#: it is journaled and ships to followers; a repack itself is not
KIND_CENTROIDS = 2
#: a leadership change: the first record a new leader journals under
#: its term. It moves no rows but takes a sequence number, so every
#: journal records where the term boundary falls
KIND_TERM = 3

_WAL_RE = re.compile(r"^wal-(\d{8})\.ckpt$")


class StreamingError(RuntimeError):
    """Base of the streaming lifecycle's failures."""


class RecoveryError(StreamingError):
    """No intact epoch snapshot could be recovered from the directory."""


class WalGapError(StreamingError):
    """A shipped WAL record skipped ahead of the next expected sequence
    number: records were lost, and the follower needs a snapshot
    resync."""

    def __init__(self, *, expected: int, got: int):
        super().__init__(
            f"WAL sequence gap: expected record {expected}, got {got} "
            f"— {got - expected} record(s) missing; snapshot resync "
            f"required")
        self.expected = int(expected)
        self.got = int(got)


class TermFencedError(StreamingError):
    """A WAL record stamped with a stale term reached a replica that has
    seen a higher one: the writer is a deposed leader. The record is
    rejected; ``divergence`` is the first sequence the deposed leader
    must truncate before it rejoins as a follower."""

    def __init__(self, *, stale_term: int, current_term: int,
                 divergence: int):
        super().__init__(
            f"term fence: record stamped term {stale_term} rejected by "
            f"a replica at term {current_term}; journals diverge at "
            f"seq {divergence} — truncate the unreplicated suffix and "
            f"rejoin as a follower")
        self.stale_term = int(stale_term)
        self.current_term = int(current_term)
        self.divergence = int(divergence)


class ShardCorruptError(StreamingError):
    """A scrub pass found damage (a failed container CRC, or packed
    state that changed with no mutation) that nothing could repair: the
    shard is quarantined, not served."""

    def __init__(self, shard: str, detail: str):
        super().__init__(f"shard {shard!r} corrupt and unrepairable: "
                         f"{detail}")
        self.shard = shard
        self.detail = detail


def _device_of(res) -> torch.device:
    """The handle's device; ``None`` is the process-wide ``cuda:0``
    handle, which raises without CUDA."""
    return get_device(default_resources(res))


def _on_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    """``x`` (tensor or array) as a tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    x = x.to(device)
    return x if dtype is None else x.to(dtype)


def _host(t: torch.Tensor):
    """A tensor on the host as the checkpoint container writes it: a
    numpy array (bf16 stays a tensor, which the container writes in the
    reference's bf16 wire form)."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _host_rows(rows):
    """Rows on the host as the journal writes them (:func:`_host` for a
    tensor)."""
    return _host(rows) if isinstance(rows, torch.Tensor) else np.asarray(rows)


def _f32_rows(rows) -> np.ndarray:
    """Host rows as an f32 array (the reservoir's and the load route's
    form)."""
    if isinstance(rows, torch.Tensor):
        return rows.detach().cpu().to(torch.float32).numpy()
    return np.asarray(rows, np.float32)


def _raw_bytes(t: torch.Tensor) -> bytes:
    """A tensor's bytes in row-major order, as ``np.asarray(a).tobytes()``
    gives a reference array's."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _coarse_assign(rows, centroids) -> Tuple[np.ndarray, np.ndarray]:
    """(nearest-centroid distance, label) per row, on the host, through
    the fused argmin ``ivf_flat._coarse_labels`` routes with (build,
    insert and the drift gauge must route a row alike)."""
    from raft_tpu_torch.cluster.kmeans import _assign

    c = centroids.to(torch.float32)
    x = _on_device(rows, c.device, torch.float32).contiguous()
    with precision.scope():
        dist, labels = _assign(x, c)
    return dist.cpu().numpy(), labels.cpu().numpy()


# ---------------------------------------------------------------------------
# mutation log: epoch snapshots + write-ahead records in one directory
# ---------------------------------------------------------------------------


class MutationLog:
    """Epoch-stamped WAL and epoch snapshots in one directory.

    WAL records are ``wal-<seq:08d>.ckpt``, epoch snapshots
    ``epoch-<n:08d>.ckpt`` (a :class:`~raft_tpu_torch.core.checkpoint
    .CheckpointManager` with retention ``RAFT_TPU_WAL_RETAIN``, or
    ``retain=``); both are written by atomic replace, so a file is either
    absent or whole. Recovery loads the newest intact epoch and replays
    the records past its ``wal_horizon``; committing an epoch prunes the
    records it folds. ``add_on_append`` registers a subscriber (a
    callable taking the durable record dict), called in registration
    order after the record is on disk; the single-slot ``on_append``
    assignment replaces them all."""

    def __init__(self, directory: str, *, retain: Optional[int] = None):
        self.directory = os.fspath(directory)
        self.retain = int(env.read("RAFT_TPU_WAL_RETAIN")
                          if retain is None else retain)
        if self.retain < 1:
            raise ValueError(f"retain must be >= 1, got {self.retain}")
        self._epochs = CheckpointManager(self.directory, prefix="epoch",
                                         keep=self.retain)
        self._lock = threading.Lock()
        seqs = [int(m.group(1)) for f in os.listdir(self.directory)
                if (m := _WAL_RE.match(f))]
        self._next_seq = max(seqs, default=-1) + 1
        self._on_append: List[Callable[[Dict], None]] = []

    # -- append subscribers -------------------------------------------

    @property
    def on_append(self) -> Optional[Callable[[Dict], None]]:
        """``None`` with no subscriber, the callable with one, the
        ordered tuple with several."""
        if not self._on_append:
            return None
        if len(self._on_append) == 1:
            return self._on_append[0]
        return tuple(self._on_append)

    @on_append.setter
    def on_append(self, fn: Optional[Callable[[Dict], None]]) -> None:
        """Replace every subscriber (``None`` clears them)."""
        with self._lock:
            self._on_append = [] if fn is None else [fn]

    def add_on_append(self, fn: Callable[[Dict], None]) -> None:
        """Register a subscriber; adding one already there keeps its
        place."""
        with self._lock:
            if fn not in self._on_append:
                self._on_append.append(fn)

    def remove_on_append(self, fn: Callable[[Dict], None]) -> None:
        """Unregister a subscriber; one not registered is a no-op. It
        compares by equality, as ``add_on_append`` does, so a bound
        method (a new object at each attribute access) is found."""
        with self._lock:
            self._on_append = [h for h in self._on_append if h != fn]

    # -- WAL ----------------------------------------------------------

    @property
    def last_seq(self) -> int:
        """Highest sequence number this log has issued or mirrored (-1
        when none)."""
        with self._lock:
            return self._next_seq - 1

    def bump_seq(self, floor_next: int) -> None:
        """Raise the next sequence number to at least ``floor_next``
        (recovery passes the snapshot's horizon + 1, so a restarted
        replica never issues a number the fleet has seen)."""
        with self._lock:
            self._next_seq = max(self._next_seq, int(floor_next))

    def append(self, entries: Dict) -> int:
        """Write one WAL record atomically and return its sequence
        number (stamped here as ``seq``); the subscribers run after it
        is durable."""
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
        rec = dict(entries)
        rec["seq"] = seq
        save_checkpoint(
            os.path.join(self.directory, f"wal-{seq:08d}.ckpt"), rec)
        for hook in list(self._on_append):
            hook(rec)
        return seq

    def append_mirror(self, rec: Dict) -> int:
        """Durably mirror one already-sequenced record under its origin
        sequence number (a follower's journal-first step); fires no
        subscriber."""
        seq = int(rec["seq"])
        with self._lock:
            self._next_seq = max(self._next_seq, seq + 1)
        save_checkpoint(
            os.path.join(self.directory, f"wal-{seq:08d}.ckpt"),
            dict(rec))
        return seq

    def wal_records(self) -> List[Dict]:
        """Every WAL record on disk, ascending sequence."""
        names = sorted(f for f in os.listdir(self.directory)
                       if _WAL_RE.match(f))
        out = []
        for name in names:
            with open(os.path.join(self.directory, name), "rb") as f:
                out.append(load_checkpoint(f))
        return out

    def prune_wal(self, *, before_epoch: Optional[int] = None,
                  through_seq: Optional[int] = None) -> int:
        """Delete the records an epoch snapshot folds: those with ``seq
        <= through_seq``, or (the older filter) those stamped with an
        epoch below ``before_epoch``. Returns how many went."""
        if (before_epoch is None) == (through_seq is None):
            raise ValueError(
                "prune_wal takes exactly one of before_epoch= / "
                "through_seq=")
        removed = 0
        for name in sorted(f for f in os.listdir(self.directory)
                           if _WAL_RE.match(f)):
            path = os.path.join(self.directory, name)
            with open(path, "rb") as f:
                rec = load_checkpoint(f)
            if through_seq is not None:
                fold = int(rec["seq"]) <= through_seq
            else:
                fold = int(rec["epoch"]) < before_epoch
            if fold:
                os.remove(path)
                removed += 1
        return removed

    def truncate_from(self, from_seq: int) -> int:
        """Delete every WAL record with ``seq >= from_seq`` and rewind
        the issue cursor to it (a deposed leader cutting the suffix the
        quorum never saw). Returns how many went."""
        from_seq = int(from_seq)
        removed = 0
        with self._lock:
            for name in sorted(f for f in os.listdir(self.directory)
                               if _WAL_RE.match(f)):
                if int(_WAL_RE.match(name).group(1)) >= from_seq:
                    os.remove(os.path.join(self.directory, name))
                    removed += 1
            self._next_seq = min(self._next_seq, from_seq)
        if removed:
            trace.record_event("streaming.wal_truncate",
                               from_seq=from_seq, removed=removed)
        return removed

    # -- epoch snapshots ----------------------------------------------

    def epoch_path(self, epoch: int) -> str:
        return self._epochs.path_for(epoch)

    def epoch_steps(self) -> List[int]:
        """Epoch numbers on disk, ascending."""
        return self._epochs.steps()

    def write_epoch(self, epoch: int, entries: Dict, *,
                    faults=None) -> None:
        """Atomic epoch write through the manager, with the
        ``compact.mid_write`` crash point between the fsynced temp file
        and the rename (a kill there leaves only ``.tmp`` debris, which
        recovery never reads); retention prunes older epochs."""
        hook = None
        if faults is not None:
            hook = lambda: faults.crash_point("compact.mid_write")  # noqa: E731
        self._epochs.save(epoch, entries, pre_replace=hook)

    def load_latest_epoch(self) -> Tuple[int, Dict]:
        """The newest intact epoch snapshot ``(number, entries)``; a
        damaged file is skipped with a trace event. Raises
        :class:`RecoveryError` when none survives."""
        nums = sorted(self._epochs.steps(), reverse=True)
        for n in nums:
            try:
                with open(self.epoch_path(n), "rb") as f:
                    return n, load_checkpoint(f)
            except CheckpointError as exc:
                trace.record_event("streaming.epoch_skip", epoch=n,
                                   error=str(exc))
        raise RecoveryError(
            f"no intact epoch snapshot in {self.directory!r} "
            f"(tried {len(nums)} files)")

    def prune_epochs(self, keep: Optional[int] = None) -> None:
        """Keep the newest ``keep`` epochs (the log's ``retain`` by
        default)."""
        keep = self.retain if keep is None else int(keep)
        nums = sorted(self._epochs.steps())
        for n in nums[:-keep] if keep else nums:
            os.remove(self.epoch_path(n))


# ---------------------------------------------------------------------------
# drift gauge
# ---------------------------------------------------------------------------


class DriftGauge:
    """EMA of ingested rows' mean nearest-centroid distance, as a ratio
    to the baseline set at build or refit. Past ``threshold``
    (``RAFT_TPU_DRIFT_THRESHOLD``) a refit is due. Exported as the
    ``streaming_drift_ratio`` gauge when metrics are on."""

    def __init__(self, threshold: Optional[float] = None,
                 alpha: float = 0.25):
        self.threshold = float(env.read("RAFT_TPU_DRIFT_THRESHOLD")
                               if threshold is None else threshold)
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._baseline: Optional[float] = None
        self._ema: Optional[float] = None

    def set_baseline(self, mean_dist: float) -> None:
        with self._lock:
            self._baseline = max(float(mean_dist), 1e-30)
            self._ema = None

    def observe_batch(self, mean_dist: float) -> float:
        """Fold one batch's mean distance into the EMA; returns the ratio
        (1.0 until a baseline exists)."""
        with self._lock:
            if self._ema is None:
                self._ema = float(mean_dist)
            else:
                self._ema += self.alpha * (float(mean_dist) - self._ema)
            ratio = self._ratio_locked()
        if obs.enabled():
            obs.set_gauge("streaming_drift_ratio", ratio)
        return ratio

    def _ratio_locked(self) -> float:
        if self._baseline is None or self._ema is None:
            return 1.0
        return self._ema / self._baseline

    @property
    def ratio(self) -> float:
        with self._lock:
            return self._ratio_locked()

    @property
    def triggered(self) -> bool:
        return self.ratio > self.threshold


# ---------------------------------------------------------------------------
# the streaming index
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Snapshot:
    """The serving view published at every commit; nothing writes its
    tensors after publication."""

    flat: IvfFlatIndex
    tomb_words: torch.Tensor      # [n_words] uint32, global-id indexed
    n_live: int
    epoch: int
    version: int


def _live_of(flat: IvfFlatIndex, words: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, int64 ids) of the occupied, untombstoned slots of ``flat``,
    ascending id, on the index's device."""
    ids = flat.packed_ids.to(torch.int64)
    live = ids >= 0
    if words.numel():
        safe = ids.clamp_min(0)
        w = words.to(torch.int64)[safe // WORD_BITS]
        live &= ((w >> (safe % WORD_BITS)) & 1) == 0
    ids_l = ids[live]
    order = torch.sort(ids_l, stable=True).indices
    return flat.packed_db[live][order], ids_l[order]


def _search_snapshot(snap: _Snapshot, queries: torch.Tensor, k: int,
                     nprobe: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tombstoned probe scan over one snapshot (the IVF path of
    :meth:`StreamingIndex.search` and of the serving body)."""
    flat = snap.flat
    return _search_body(
        queries, flat.centroids, flat.packed_db, flat.packed_ids,
        flat.starts, flat.sizes, snap.tomb_words, k=k, nprobe=nprobe,
        cap_max=flat.cap_max, metric=flat.metric,
        use_radix=_use_radix(nprobe * flat.cap_max, k))


class StreamingIndex:
    """A mutable, crash-safe IVF-Flat index (see the module docstring).

    Made by :func:`stream_build` or :meth:`StreamingIndex.recover`. With
    no ``log`` it runs in memory: the same mutation, compaction and
    drift machinery, no journal writes. The device is ``flat``'s."""

    def __init__(self, flat: IvfFlatIndex, *,
                 log: Optional[MutationLog] = None,
                 faults=None, res=None,
                 drift: Optional[DriftGauge] = None,
                 epoch: int = 0, next_id: Optional[int] = None,
                 tomb_host: Optional[np.ndarray] = None,
                 n_live: Optional[int] = None,
                 reservoir_cap: int = 4096,
                 repack_slack: int = SLOT_ALIGN,
                 term: int = 0):
        self._lock = threading.RLock()
        self.log = log
        # highest WAL sequence folded into the state in memory: the
        # horizon an epoch snapshot stamps (a replay's repack must not
        # claim records it has not applied yet)
        self._applied_seq = log.last_seq if log is not None else -1
        # leadership term: stamped into every record and snapshot,
        # only ever advances
        self._term = int(term)
        # the sequence at which the current term began
        self._term_start = 0
        # optional post-commit barrier: called with a mutation's seq
        # after journal and apply, outside the lock (quorum acks)
        self._commit_barrier: Optional[Callable[[int], None]] = None
        # bounded client write_id -> assigned ids map: a batch replayed
        # at a new leader returns its original ids
        self._write_ids: "collections.OrderedDict[int, np.ndarray]" = \
            collections.OrderedDict()
        self._write_ids_cap = 1024
        self.faults = faults
        self.res = res
        self.device = flat.centroids.device
        self.drift = drift if drift is not None else DriftGauge()
        self._flat = flat
        self._epoch = int(epoch)
        self._version = 0
        self._next_id = int(flat.n_db if next_id is None else next_id)
        self._n_live = int(flat.n_db if n_live is None else n_live)
        if tomb_host is None:
            tomb_host = np.zeros(self._tomb_n_words(flat, self._next_id),
                                 np.uint32)
        self._tomb_host = np.asarray(tomb_host, np.uint32).copy()
        self._reservoir: List[np.ndarray] = []
        self._reservoir_rows = 0
        self._reservoir_cap = int(reservoir_cap)
        # free tail slots per list a repack leaves: size it to the
        # expected insert batch, so ingest fills tails in place
        self.repack_slack = max(int(repack_slack), SLOT_ALIGN)
        self._pf_counts: Optional[np.ndarray] = None
        self._snapshot = _Snapshot(
            flat=flat, tomb_words=self._words(), n_live=self._n_live,
            epoch=self._epoch, version=0)
        self._history: collections.deque = collections.deque(maxlen=8)
        self._history.append(self._snapshot)

    # -- construction helpers -----------------------------------------

    @staticmethod
    def _tomb_n_words(flat: IvfFlatIndex, next_id: int) -> int:
        """Words covering every id this epoch's tensors can hold: the
        ids given so far plus one per free slot (an overflowing insert
        starts a new epoch with a new set), so the shape is fixed for
        the epoch."""
        free = int(flat.packed_db.shape[0]) - int(flat.n_db)
        n_bits = max(int(next_id) + max(free, 0), 1)
        return (n_bits + WORD_BITS - 1) // WORD_BITS

    def _words(self) -> torch.Tensor:
        """A device copy of the host tombstone words (never aliased by
        a later delete, on the CPU either)."""
        return torch.from_numpy(self._tomb_host.copy()).to(self.device)

    @classmethod
    def recover(cls, res, directory: str, *, faults=None,
                drift: Optional[DriftGauge] = None,
                retain: Optional[int] = None) -> "StreamingIndex":
        """The index the journal describes, on the handle's device: the
        newest intact epoch snapshot, then the WAL records past its
        ``wal_horizon`` in sequence order (a snapshot with no horizon,
        as the oldest format, replays the records stamped with its
        epoch). Inserts replay with their journaled labels, so the
        routing is the journal's on any device. Nothing is re-journaled,
        and the WAL cursor moves past the horizon."""
        device = _device_of(res)
        log = MutationLog(directory, retain=retain)
        epoch, ent = log.load_latest_epoch()
        flat = _flat_from_entries(ent, device)
        idx = cls(flat, log=log, faults=faults, res=res, drift=drift,
                  epoch=epoch, next_id=int(ent["next_id"]),
                  tomb_host=np.asarray(ent["tomb_words"], np.uint32),
                  n_live=int(ent["n_live"]),
                  term=int(ent.get("wal_term", 0)))
        idx._term_start = int(ent.get("wal_term_start", 0))
        horizon = int(ent["wal_horizon"]) if "wal_horizon" in ent \
            else None
        if horizon is not None:
            idx._applied_seq = horizon
        replayed = 0
        for rec in log.wal_records():
            if horizon is not None:
                if int(rec["seq"]) <= horizon:
                    continue
            elif int(rec["epoch"]) != epoch:
                continue
            kind = int(rec["kind"])
            # applied before the dispatch: a repack inside the apply
            # folds this record, so its horizon must cover it
            if "seq" in rec:
                idx._applied_seq = int(rec["seq"])
            idx._term = max(idx._term, int(rec.get("term", 0)))
            if kind == KIND_INSERT:
                ids = idx._apply_insert(
                    _host_rows(rec["data"]),
                    np.asarray(rec["labels"], np.int64),
                    journal=False)
                if "write_id" in rec:
                    idx.note_write_id(int(rec["write_id"]), ids)
            elif kind == KIND_DELETE:
                idx._apply_delete(np.asarray(rec["data"], np.int64),
                                  journal=False)
            elif kind == KIND_CENTROIDS:
                with idx._lock:
                    idx._repack_locked(
                        centroids=np.asarray(rec["data"], np.float32),
                        reason="refit_replay")
            elif kind == KIND_TERM:
                idx._term = max(idx._term,
                                int(np.asarray(rec["data"]).ravel()[0]))
                idx._term_start = int(rec["seq"])
            else:
                raise RecoveryError(f"unknown WAL record kind {kind}")
            replayed += 1
        if horizon is not None:
            log.bump_seq(horizon + 1)
        if obs.enabled():
            obs.inc("streaming_replay_records_total", replayed)
        trace.record_event("streaming.recover", epoch=epoch,
                           replayed=replayed, n_live=idx.n_live)
        return idx

    def install_snapshot(self, ent: Dict) -> None:
        """Replace the whole content with shipped epoch entries (a
        catch-up too wide to replay, or a repair): rebuild the packed
        state on this index's device, bump the local epoch, persist it,
        move the WAL cursor past the snapshot's horizon and publish."""
        with self._lock:
            flat = _flat_from_entries(ent, self.device)
            self._flat = flat
            self._epoch += 1
            self._next_id = int(ent["next_id"])
            self._n_live = int(ent["n_live"])
            self._tomb_host = np.asarray(ent["tomb_words"],
                                         np.uint32).copy()
            self._applied_seq = int(ent.get("wal_horizon", -1))
            self._term = max(self._term, int(ent.get("wal_term", 0)))
            self._term_start = max(self._term_start,
                                   int(ent.get("wal_term_start", 0)))
            if self.log is not None:
                self.log.bump_seq(self._applied_seq + 1)
            self._write_epoch_locked(crash=False)
            self._publish_locked()
        if obs.enabled():
            obs.inc("streaming_snapshot_installs_total")
        trace.record_event("streaming.install_snapshot",
                           epoch=self._epoch, n_live=self._n_live)

    # -- read side (snapshot-backed, lock-free) -----------------------

    @property
    def snapshot(self) -> _Snapshot:
        return self._snapshot

    @property
    def flat(self) -> IvfFlatIndex:
        return self._snapshot.flat

    @property
    def n_live(self) -> int:
        return self._snapshot.n_live

    @property
    def epoch(self) -> int:
        return self._snapshot.epoch

    @property
    def version(self) -> int:
        return self._snapshot.version

    @property
    def next_id(self) -> int:
        with self._lock:
            return self._next_id

    @property
    def term(self) -> int:
        """Current leadership term (only ever advances)."""
        with self._lock:
            return self._term

    @property
    def applied_seq(self) -> int:
        """Highest WAL sequence folded into the state in memory."""
        with self._lock:
            return self._applied_seq

    def begin_term(self, new_term: int) -> int:
        """Adopt a higher term and journal the boundary as a
        :data:`KIND_TERM` record (a new leader's first write); returns
        its seq."""
        with self._lock:
            if int(new_term) <= self._term:
                raise StreamingError(
                    f"begin_term: new term {int(new_term)} must exceed "
                    f"current term {self._term}")
            self._term = int(new_term)
            self._journal(KIND_TERM,
                          np.asarray([self._term], np.int64))
            seq = self._applied_seq
            self._term_start = seq
        trace.record_event("streaming.begin_term", term=int(new_term),
                           seq=seq)
        return seq

    def adopt_term(self, new_term: int) -> None:
        """Raise the local term without journaling (a follower's side of
        an election)."""
        with self._lock:
            self._term = max(self._term, int(new_term))

    def note_write_id(self, write_id: int, ids: np.ndarray) -> None:
        """Record a client write_id and the ids it was given."""
        with self._lock:
            self._write_ids[int(write_id)] = np.asarray(ids, np.int64)
            self._write_ids.move_to_end(int(write_id))
            while len(self._write_ids) > self._write_ids_cap:
                self._write_ids.popitem(last=False)

    def seen_write_id(self, write_id: int) -> Optional[np.ndarray]:
        """The ids an applied ``write_id`` was given, or None."""
        with self._lock:
            ids = self._write_ids.get(int(write_id))
            return None if ids is None else ids.copy()

    def tombstone_fraction(self) -> float:
        """Dead rows still in packed slots over packed rows."""
        snap = self._snapshot
        packed = int(snap.flat.n_db)
        return (packed - snap.n_live) / max(packed, 1)

    def tail_full_fraction(self) -> float:
        """Fraction of lists whose padded tail is full (the next insert
        routed there repacks)."""
        snap = self._snapshot
        sizes = snap.flat.sizes.cpu().numpy().astype(np.int64)
        return float(np.mean(sizes >= snap.flat.caps)) if len(sizes) \
            else 0.0

    def _dead_host(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        return (self._tomb_host[ids // WORD_BITS]
                >> (ids % WORD_BITS).astype(np.uint32)) & 1

    def _live_device(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`live_rows` on the index's device (rows, int64 ids)."""
        with self._lock:
            snap = self._snapshot
            words = self._words()
        return _live_of(snap.flat, words)

    def live_rows(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, ids) of every live row on the host, ascending id: the
        canonical content order (CRC input, exact-search database)."""
        rows, ids = self._live_device()
        return _host(rows), ids.cpu().numpy()

    def content_crc(self) -> int:
        """CRC32 over ids (int64) ‖ rows in id order ‖ centroids (f32):
        independent of the packing, so a compaction keeps it and a
        recovered replica matches its twin."""
        rows, ids = self._live_device()
        snap = self._snapshot
        c = zlib.crc32(_raw_bytes(ids))
        c = zlib.crc32(_raw_bytes(rows), c)
        c = zlib.crc32(_raw_bytes(snap.flat.centroids.to(torch.float32)), c)
        return c

    # -- journaling ----------------------------------------------------

    def _crash(self, name: str) -> None:
        if self.faults is not None:
            self.faults.crash_point(name)

    def _journal(self, kind: int, data: np.ndarray,
                 labels: Optional[np.ndarray] = None,
                 write_id: Optional[int] = None) -> None:
        if self.log is None:
            return
        rec: Dict = {"kind": kind, "epoch": self._epoch, "data": data,
                     "term": self._term}
        if labels is not None:
            rec["labels"] = np.asarray(labels, np.int64)
        if write_id is not None:
            rec["write_id"] = int(write_id)
        # journal first: the apply follows under the same lock
        self._applied_seq = self.log.append(rec)

    def _write_epoch_locked(self, *, crash: bool = True) -> None:
        """Persist the state in memory as this epoch's snapshot, then
        prune the WAL records it folds (by the horizon stamped into it:
        sequence numbers are the one fleet-wide order). ``crash=False``
        skips the protocol's crash points (the build's epoch 0)."""
        if self.log is None:
            return
        ent = _epoch_entries(self)
        self.log.write_epoch(self._epoch, ent,
                             faults=self.faults if crash else None)
        if crash:
            self._crash("compact.post_commit")
        self.log.prune_wal(through_seq=int(ent["wal_horizon"]))

    # -- mutation ------------------------------------------------------

    def insert(self, rows, labels: Optional[np.ndarray] = None, *,
               write_id: Optional[int] = None) -> np.ndarray:
        """Append rows and return their ids (arrival order, stable
        forever). Journal first: the record (rows and routing labels)
        is durable before the apply. ``write_id`` makes the insert
        idempotent across a failover. Rows that fit the tails are
        written in place (every shape kept); an overflow repacks under a
        new epoch."""
        rows = _host_rows(rows)
        if rows.ndim != 2 or rows.shape[1] != self._snapshot.flat.dim:
            raise ValueError(
                f"rows must be [m, {self._snapshot.flat.dim}], got "
                f"{rows.shape}")
        if rows.shape[0] == 0:
            return np.zeros((0,), np.int64)
        with self._lock:
            if write_id is not None:
                prior = self.seen_write_id(write_id)
                if prior is not None:
                    if obs.enabled():
                        obs.inc("streaming_write_dedups_total")
                    return prior
            if labels is None:
                dist, labels = _coarse_assign(rows,
                                              self._flat.centroids)
                self.drift.observe_batch(float(np.mean(dist)))
            labels = np.asarray(labels, np.int64)
            if labels.shape != (rows.shape[0],) or \
                    labels.min(initial=0) < 0 or \
                    labels.max(initial=0) >= self._flat.n_lists:
                raise ValueError(
                    f"labels must be [{rows.shape[0]}] list indices in "
                    f"[0, {self._flat.n_lists})")
            self._crash("ingest.pre_journal")
            self._journal(KIND_INSERT, rows, labels,
                          write_id=write_id)
            self._crash("ingest.post_journal")
            seq = self._applied_seq
            ids = self._apply_insert(rows, labels, journal=True)
            if write_id is not None:
                self.note_write_id(write_id, ids)
        barrier = self._commit_barrier
        if barrier is not None:
            barrier(seq)
        if obs.enabled():
            obs.inc("streaming_inserts_total", int(rows.shape[0]))
        return ids

    def _apply_insert(self, rows: np.ndarray, labels: np.ndarray,
                      *, journal: bool) -> np.ndarray:
        with self._lock:
            flat = self._flat
            m = int(rows.shape[0])
            ids = np.arange(self._next_id, self._next_id + m,
                            dtype=np.int64)
            sizes = flat.sizes.cpu().numpy().astype(np.int64)
            add = np.bincount(labels, minlength=flat.n_lists
                              ).astype(np.int64)
            tomb_bits = self._tomb_host.shape[0] * WORD_BITS
            if np.any(sizes + add > flat.caps) or \
                    ids[-1] >= tomb_bits:
                # overflow: live rows and the new ones repack into a new
                # epoch; next_id advances first (the new rows ride into
                # the epoch file)
                self._next_id += m
                self._repack_locked(extra_rows=rows, extra_ids=ids,
                                    reason="insert_overflow")
                self._reserve(rows)
                return ids
            order, slots, add = _append_slots(
                labels, flat.starts.cpu().numpy().astype(np.int64), sizes,
                flat.n_lists)
            dev = flat.packed_db.device
            slots_t = torch.from_numpy(slots).to(dev)
            # new tensors: a published snapshot's are never written
            packed_db = flat.packed_db.clone()
            packed_ids = flat.packed_ids.clone()
            packed_db.index_copy_(
                0, slots_t, _on_device(rows[order], dev, packed_db.dtype))
            packed_ids.index_copy_(
                0, slots_t,
                torch.from_numpy(ids[order].astype(np.int32)).to(dev))
            self._flat = IvfFlatIndex(
                centroids=flat.centroids, packed_db=packed_db,
                packed_ids=packed_ids, starts=flat.starts,
                sizes=torch.from_numpy(sizes + add).to(dev, torch.int32),
                caps=flat.caps, cap_max=flat.cap_max,
                n_db=flat.n_db + m, metric=flat.metric)
            self._n_live += m
            self._publish_locked()
            self._next_id += m
            self._reserve(rows)
            return ids

    def delete(self, ids) -> int:
        """Tombstone ids; returns how many went from live to dead (an
        already dead id is a no-op, so a replayed delete converges).
        Journal first, as :meth:`insert`; the words keep their shape."""
        ids = np.asarray(ids, np.int64).ravel()
        if ids.size == 0:
            return 0
        with self._lock:
            if ids.min() < 0 or ids.max() >= self._next_id:
                raise ValueError(
                    f"ids must be in [0, {self._next_id}), got range "
                    f"[{ids.min()}, {ids.max()}]")
            self._crash("ingest.pre_journal")
            self._journal(KIND_DELETE, ids)
            self._crash("ingest.post_journal")
            seq = self._applied_seq
            flipped = self._apply_delete(ids, journal=True)
        barrier = self._commit_barrier
        if barrier is not None:
            barrier(seq)
        if obs.enabled():
            obs.inc("streaming_deletes_total", flipped)
            obs.set_gauge("streaming_tombstone_frac",
                          self.tombstone_fraction())
        return flipped

    def _apply_delete(self, ids: np.ndarray, *, journal: bool) -> int:
        with self._lock:
            ids = np.asarray(ids, np.int64).ravel()
            was_dead = self._dead_host(ids).astype(bool)
            fresh = np.unique(ids[~was_dead])
            np.bitwise_or.at(
                self._tomb_host, fresh // WORD_BITS,
                np.uint32(1) << (fresh % WORD_BITS).astype(np.uint32))
            self._n_live -= int(fresh.size)
            self._publish_locked()
            return int(fresh.size)

    # -- snapshot publication -----------------------------------------

    def _publish_locked(self) -> None:
        self._version += 1
        self._snapshot = _Snapshot(
            flat=self._flat, tomb_words=self._words(),
            n_live=self._n_live, epoch=self._epoch,
            version=self._version)
        self._history.append(self._snapshot)

    def recent_snapshots(self) -> List[_Snapshot]:
        """The last few published snapshots, oldest first: a query in
        flight across a swap may serve any of the versions of its
        window."""
        with self._lock:
            return list(self._history)

    # -- compaction / repack ------------------------------------------

    def _repack_locked(self, *, extra_rows=None, extra_ids=None,
                       centroids=None, reason: str = "compact") -> None:
        """Pack the live rows (and ``extra_rows``) under their ids into
        fresh tensors, bump the epoch, persist it, prune the folded WAL
        and publish. The caller holds the mutation lock."""
        t0 = time.monotonic()
        rows, ids = self._live_device()
        if extra_rows is not None:
            rows = torch.cat([rows, _on_device(extra_rows, rows.device,
                                               rows.dtype)])
            ids = torch.cat([ids, _on_device(
                np.asarray(extra_ids, np.int64), ids.device)])
        centroids = self._flat.centroids if centroids is None \
            else _on_device(centroids, self.device, torch.float32)
        flat = _flat_from_live(rows, ids, centroids, self._flat.metric,
                               slack_slots=self.repack_slack)
        self._flat = flat
        self._epoch += 1
        self._n_live = int(rows.shape[0])
        top = int(ids.max()) if ids.numel() else -1
        self._tomb_host = np.zeros(
            self._tomb_n_words(flat, max(self._next_id, top + 1)),
            np.uint32)
        self._crash("compact.pre_commit")
        self._write_epoch_locked()
        self._publish_locked()
        self._crash("compact.post_swap")
        if obs.enabled():
            obs.inc("streaming_compactions_total")
            obs.observe("streaming_compact_seconds",
                        time.monotonic() - t0)
        trace.record_event("streaming.compact", reason=reason,
                           epoch=self._epoch, n_live=self._n_live,
                           seconds=round(time.monotonic() - t0, 4))

    def compact(self, *, reason: str = "compact") -> None:
        """One compaction: the pack of the live rows off the mutation
        lock, then a short locked commit (a repack of the delta when a
        mutation raced the pack). Searches read the old snapshot until
        the swap. The repack's bytes are priced through the
        ``neighbors.streaming_compact`` cost model."""
        from raft_tpu_torch.runtime import limits

        self._crash("compact.pre_pack")
        with self._lock:
            snap_version = self._version
            snap_next = self._next_id
        rows, ids = self._live_device()
        snap = self._snapshot
        est = limits.estimate_bytes(
            "neighbors.streaming_compact",
            packed_rows=int(snap.flat.packed_db.shape[0]),
            n_dims=snap.flat.dim,
            itemsize=snap.flat.packed_db.element_size())
        with obs.span("streaming.compact"):
            new_flat = _flat_from_live(rows, ids, snap.flat.centroids,
                                       snap.flat.metric,
                                       slack_slots=self.repack_slack)
            with self._lock:
                if self._version != snap_version:
                    trace.record_event("streaming.compact_delta",
                                       from_version=snap_version,
                                       to_version=self._version)
                    self._repack_locked(reason=reason + "_delta")
                else:
                    self._flat = new_flat
                    self._epoch += 1
                    self._n_live = int(rows.shape[0])
                    self._tomb_host = np.zeros(
                        self._tomb_n_words(new_flat, max(snap_next, 1)),
                        np.uint32)
                    self._crash("compact.pre_commit")
                    self._write_epoch_locked()
                    self._publish_locked()
                    self._crash("compact.post_swap")
                    if obs.enabled():
                        obs.inc("streaming_compactions_total")
                    trace.record_event(
                        "streaming.compact", reason=reason,
                        epoch=self._epoch, n_live=self._n_live,
                        est_bytes=int(est))

    # -- drift-aware refit --------------------------------------------

    def _reserve(self, rows: np.ndarray) -> None:
        """Keep the most recent inserted rows (bounded) as the refit's
        mini-batch."""
        self._reservoir.append(_f32_rows(rows))
        self._reservoir_rows += int(rows.shape[0])
        while self._reservoir and \
                self._reservoir_rows - self._reservoir[0].shape[0] \
                >= self._reservoir_cap:
            self._reservoir_rows -= self._reservoir[0].shape[0]
            self._reservoir.pop(0)

    def maybe_refit(self, *, force: bool = False) -> bool:
        """When the drift gauge is past its threshold (or ``force``):
        ``kmeans_partial_fit`` of the centroids on the recent-insert
        reservoir, seeded with each list's live mass, a repack under the
        new centroids (a refit epoch) and a baseline reset. A journaled
        index checkpoints the fit at every chunk under
        ``<journal>/refit``. Returns True when a refit ran."""
        if not (force or self.drift.triggered):
            return False
        with self._lock:
            if not self._reservoir:
                return False
            batch = np.concatenate(self._reservoir, axis=0)
            flat = self._flat
            sizes = flat.sizes.to(torch.float32)
        from raft_tpu_torch.cluster.kmeans import kmeans_partial_fit

        ckpt: Dict = {}
        if self.log is not None:
            ckpt = dict(
                checkpoint_dir=os.path.join(self.log.directory,
                                            "refit"),
                checkpoint_every=1)
        new_c, counts = kmeans_partial_fit(
            self.res, flat.centroids,
            _on_device(batch, flat.centroids.device), counts=sizes,
            **ckpt)
        with self._lock:
            self._pf_counts = counts.cpu().numpy()
            # journal first: the centroids are content (in the CRC)
            self._journal(KIND_CENTROIDS,
                          new_c.to(torch.float32).cpu().numpy())
            self._repack_locked(centroids=new_c, reason="refit")
        dist, _ = _coarse_assign(batch, new_c)
        self.drift.set_baseline(float(np.mean(dist)))
        if obs.enabled():
            obs.inc("streaming_refits_total")
        trace.record_event("streaming.refit", rows=int(batch.shape[0]),
                           epoch=self.epoch)
        return True

    # -- search --------------------------------------------------------

    def search(self, queries, k: int, nprobe: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """k nearest live rows per query in id numbering, as
        :func:`ivf_flat.search` returns them. The partial probe masks
        tombstoned rows in the scan (bitwise a rebuild without them for
        the candidates scanned); ``nprobe >= n_lists`` is ``knn`` over
        the live rows. No work budget is applied here (the reference's
        call)."""
        snap = self._snapshot
        flat = snap.flat
        queries = _on_device(queries, flat.centroids.device)
        if queries.dim() != 2 or queries.shape[1] != flat.dim:
            raise ValueError(f"queries must be [q, {flat.dim}], got "
                             f"{tuple(queries.shape)}")
        if not 0 < k <= snap.n_live:
            raise ValueError(f"need 0 < k <= n_live, got k={k}, "
                             f"n_live={snap.n_live}")
        if nprobe <= 0:
            raise ValueError(f"need nprobe > 0, got {nprobe}")
        if nprobe >= flat.n_lists:
            from raft_tpu_torch.neighbors.brute_force import knn

            rows, ids = self._live_device()
            trace.record_event("streaming.search", nprobe=flat.n_lists,
                               k=k, path="exact", epoch=snap.epoch)
            dist, idx = knn(self.res, rows, queries, k,
                            metric=flat.metric)
            ids32 = ids.to(torch.int32)
            ext = torch.where(idx >= 0, ids32[idx.clamp_min(0).long()],
                              torch.full_like(idx, -1))
            return dist, ext
        probe_rows = nprobe * flat.cap_max
        if probe_rows < k:
            raise ValueError(
                f"nprobe={nprobe} reaches at most {probe_rows} "
                f"candidates < k={k}; raise nprobe")
        trace.record_event("streaming.search", nprobe=nprobe, k=k,
                           path="ivf", epoch=snap.epoch)
        return _search_snapshot(snap, queries, k, nprobe)


def _flat_from_live(rows, ids, centroids, metric: str,
                    slack_slots: int = SLOT_ALIGN) -> IvfFlatIndex:
    """Pack ``(rows, ids)`` (ids unique, in any order) into a fresh
    IvfFlatIndex under ``centroids``, on their device, leaving at least
    ``slack_slots`` free tail slots a list. ``ivf_flat.build``'s routing
    and packer, with the ids kept (never renumbered); rows go in by
    ascending id, so each list is id-sorted as the tail append needs."""
    centroids = _on_device(centroids, centroids.device
                           if isinstance(centroids, torch.Tensor)
                           else torch.device("cpu"), torch.float32)
    dev = centroids.device
    n_lists = int(centroids.shape[0])
    rows = _on_device(rows, dev)
    if rows.shape[0] == 0:
        caps = np.zeros(n_lists, np.int64)
        zeros = torch.zeros((n_lists,), dtype=torch.int32, device=dev)
        return IvfFlatIndex(
            centroids=centroids,
            packed_db=rows.new_zeros((0, int(centroids.shape[1]))),
            packed_ids=torch.zeros((0,), dtype=torch.int32, device=dev),
            starts=zeros, sizes=zeros.clone(), caps=caps, cap_max=0,
            n_db=0, metric=metric)
    labels = _coarse_labels(rows, centroids)
    ids_np = (ids.cpu().numpy() if isinstance(ids, torch.Tensor)
              else np.asarray(ids)).astype(np.int64)
    order = np.argsort(ids_np, kind="stable")
    rows = rows[torch.from_numpy(order).to(dev)]
    ids32 = torch.from_numpy(ids_np[order].astype(np.int32))
    labels = np.asarray(labels)[order]
    packed_db, packed_ids, starts, counts, caps = _pack(
        rows, ids32, labels, n_lists, slack_slots=slack_slots)
    return IvfFlatIndex(
        centroids=centroids, packed_db=packed_db, packed_ids=packed_ids,
        starts=torch.from_numpy(starts).to(dev, torch.int32),
        sizes=torch.from_numpy(counts).to(dev, torch.int32),
        caps=caps, cap_max=int(caps.max(initial=0)),
        n_db=int(rows.shape[0]), metric=metric)


def stream_build(res, db, n_lists: int, metric: str = "l2", *,
                 directory: Optional[str] = None, max_iter: int = 25,
                 seed: int = 0, faults=None,
                 drift: Optional[DriftGauge] = None,
                 repack_slack: int = SLOT_ALIGN) -> StreamingIndex:
    """A fresh streaming index on the handle's device (``cuda:0`` for
    ``res=None``, which raises without CUDA): train and pack through
    :func:`ivf_flat.build`, journal epoch 0 when a ``directory`` is
    given, and set the drift baseline from the training rows' mean
    nearest-centroid distance."""
    db = _on_device(db, _device_of(res))
    flat = build(res, db, n_lists, metric, max_iter=max_iter, seed=seed)
    log = MutationLog(directory) if directory is not None else None
    idx = StreamingIndex(flat, log=log, faults=faults, res=res,
                         drift=drift, repack_slack=repack_slack)
    dist, _ = _coarse_assign(db, flat.centroids)
    idx.drift.set_baseline(float(np.mean(dist)))
    if log is not None:
        with idx._lock:
            idx._write_epoch_locked(crash=False)
    return idx


def _epoch_entries(idx: StreamingIndex) -> Dict:
    """An epoch snapshot's entries, the reference's names and dtypes:
    ``starts``/``sizes``/``caps`` int64, ``metric`` uint8 bytes,
    ``tomb_words`` uint32."""
    flat = idx._flat
    return {
        "epoch": idx._epoch,
        "next_id": idx._next_id,
        "n_live": idx._n_live,
        "n_db": int(flat.n_db),
        # highest WAL sequence folded in: recovery replays past it, the
        # commit prunes through it
        "wal_horizon": idx._applied_seq,
        "wal_term": idx._term,
        "wal_term_start": idx._term_start,
        "metric": np.frombuffer(flat.metric.encode(), np.uint8),
        "centroids": flat.centroids.to(torch.float32).cpu().numpy(),
        "packed_db": _host(flat.packed_db),
        "packed_ids": flat.packed_ids.to(torch.int32).cpu().numpy(),
        "starts": flat.starts.cpu().numpy().astype(np.int64),
        "sizes": flat.sizes.cpu().numpy().astype(np.int64),
        "caps": np.asarray(flat.caps, np.int64),
        "tomb_words": idx._tomb_host.copy(),
    }


def _flat_from_entries(ent: Dict, device) -> IvfFlatIndex:
    """The packed :class:`IvfFlatIndex` of an epoch snapshot's entries
    on ``device`` (the inverse of :func:`_epoch_entries`): recovery
    from disk and a shipped snapshot."""
    metric = bytes(np.asarray(ent["metric"], np.uint8)).decode()
    _resolve_metric(metric)
    caps = np.asarray(ent["caps"], np.int64)
    device = torch.device(device)
    return IvfFlatIndex(
        centroids=_on_device(np.asarray(ent["centroids"], np.float32),
                             device),
        packed_db=_on_device(ent["packed_db"], device),
        packed_ids=_on_device(np.asarray(ent["packed_ids"], np.int32),
                              device),
        starts=_on_device(np.asarray(ent["starts"], np.int32), device),
        sizes=_on_device(np.asarray(ent["sizes"], np.int32), device),
        caps=caps, cap_max=int(caps.max(initial=0)),
        n_db=int(ent["n_db"]), metric=metric)


# ---------------------------------------------------------------------------
# background compactor
# ---------------------------------------------------------------------------


class Compactor:
    """Background compaction: every ``RAFT_TPU_COMPACT_INTERVAL``
    seconds, one :meth:`StreamingIndex.compact` when the tombstone
    fraction or the full-tail fraction reaches
    ``RAFT_TPU_COMPACT_TOMBSTONE_FRAC``, and :meth:`StreamingIndex
    .maybe_refit`. ``on_change`` runs on the worker after a cycle that
    changed the index. The worker thread's device work goes to the
    default stream (a new thread's current stream), as every other
    thread's here. A worker failure goes to the flight recorder and is
    raised again by :meth:`stop`."""

    def __init__(self, index: StreamingIndex, *,
                 interval: Optional[float] = None,
                 tombstone_frac: Optional[float] = None,
                 refit: bool = True,
                 on_change: Optional[Callable[[], None]] = None):
        self.index = index
        self.on_change = on_change
        self.interval = float(env.read("RAFT_TPU_COMPACT_INTERVAL")
                              if interval is None else interval)
        self.tombstone_frac = float(
            env.read("RAFT_TPU_COMPACT_TOMBSTONE_FRAC")
            if tombstone_frac is None else tombstone_frac)
        self.refit = bool(refit)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.cycles = 0
        self.compactions = 0

    def should_compact(self) -> bool:
        """Due when dead rows hold too many packed slots or too many list
        tails are full (one threshold for both)."""
        return (self.index.tombstone_fraction() >= self.tombstone_frac
                or self.index.tail_full_fraction()
                >= self.tombstone_frac)

    def run_once(self) -> bool:
        """One poll: compact and/or refit if due; True when either
        ran."""
        self.cycles += 1
        ran = False
        if self.should_compact():
            self.index.compact(reason="background")
            self.compactions += 1
            ran = True
        if self.refit and self.index.maybe_refit():
            ran = True
        if ran and self.on_change is not None:
            self.on_change()
        return ran

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.run_once()
            except Exception as exc:  # noqa: BLE001 — raised at stop
                self._error = exc
                obs.record_failure(exc)
                trace.record_event("streaming.compactor_error",
                                   error=str(exc))
                return

    def start(self) -> "Compactor":
        if self._thread is not None:
            raise StreamingError("compactor already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="raft-tpu-compactor")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the worker and raise any failure it died on."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise StreamingError(
                "background compactor failed") from err

    def __enter__(self) -> "Compactor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# MNMG: routed ingest + rebalance over the sharded index
# ---------------------------------------------------------------------------


class StreamingMnmg:
    """Streaming front of the sharded index: mutations go to the one
    :class:`StreamingIndex` (one journal, one epoch protocol), the
    shards are carved again whenever its version moved, and partial
    probes run through :func:`ivf_mnmg.search_mnmg` with the tombstone
    words on every rank. Without a ``mesh`` the shards are host-carved
    and a search runs each rank's half in this process
    (:func:`ivf_mnmg.search_local`) and merges them
    (:func:`ivf_mnmg.merge_pool`), the same bits.

    ``route="nearest"`` keeps the single-rank index's bits;
    ``route="load"`` sends a row whose runner-up centroid is within
    ``slack`` x of its nearest to whichever of the two lists the
    less-loaded rank owns (the next compaction's rebalance restores
    nearest placement)."""

    ROUTES = ("nearest", "load")

    def __init__(self, stream: StreamingIndex, n_ranks: int, *,
                 mesh=None, axis: str = "ranks",
                 route: str = "nearest", slack: float = 1.05):
        from raft_tpu_torch.neighbors.ivf_mnmg import _from_flat

        if route not in self.ROUTES:
            raise ValueError(f"route must be one of {self.ROUTES}, "
                             f"got {route!r}")
        self.stream = stream
        self.n_ranks = int(n_ranks)
        self.route = route
        self.slack = float(slack)
        self._lock = threading.Lock()
        self._mnmg = _from_flat(stream.flat, self.n_ranks, mesh=mesh,
                                axis=axis)
        self._sharded_version = stream.version

    @property
    def mnmg(self):
        self._refresh()
        return self._mnmg

    def _refresh(self) -> None:
        from raft_tpu_torch.neighbors.ivf_mnmg import rebalance_mnmg

        with self._lock:
            v = self.stream.version
            if v != self._sharded_version:
                self._mnmg = rebalance_mnmg(self._mnmg,
                                            flat=self.stream.flat,
                                            mesh=self._mnmg.mesh)
                self._sharded_version = v
                trace.record_event("streaming.reshard", version=v,
                                   n_ranks=self.n_ranks)

    def rank_loads(self) -> np.ndarray:
        """Packed rows each rank owns."""
        idx = self.mnmg
        sizes = self.stream.flat.sizes.cpu().numpy().astype(np.int64)
        loads = np.zeros(self.n_ranks, np.int64)
        np.add.at(loads, idx.owner, sizes)
        return loads

    def _route_labels(self, rows: np.ndarray) -> np.ndarray:
        """Each row's list under the route. The nearest label is the
        fused assign's, as the single-rank index routes; the load route
        takes the runner-up only at a near-tie owned by a less-loaded
        rank."""
        centroids = self.stream.flat.centroids
        dist, labels = _coarse_assign(rows, centroids)
        self.stream.drift.observe_batch(float(np.mean(dist)))
        labels = np.asarray(labels, np.int64)
        n_lists = int(centroids.shape[0])
        if self.route == "nearest" or n_lists < 2:
            return labels
        cents = centroids.to(torch.float32).cpu().numpy()
        rows = _f32_rows(rows)
        d2 = (np.sum(rows * rows, 1)[:, None]
              - 2.0 * rows @ cents.T
              + np.sum(cents * cents, 1)[None, :])
        ar = np.arange(len(rows))
        d2[ar, labels] = np.inf                   # mask the winner
        second = np.argmin(d2, axis=1)
        owner = self.mnmg.owner
        loads = self.rank_loads().astype(np.float64)
        tie = d2[ar, second] <= \
            np.maximum(dist.astype(np.float64), 1e-30) * self.slack ** 2
        prefer_second = loads[owner[second]] < loads[owner[labels]]
        return np.where(tie & prefer_second, second, labels)

    def insert(self, rows) -> np.ndarray:
        """Routed insert: the labels are journaled with the rows, so a
        replay keeps the placement whatever the loads then."""
        rows = _host_rows(rows)
        labels = self._route_labels(rows)
        ids = self.stream.insert(rows, labels=labels)
        self._refresh()
        return ids

    def delete(self, ids) -> int:
        n = self.stream.delete(ids)
        self._refresh()
        return n

    def rebalance(self) -> None:
        """Compact and carve again (the repack a rank's death runs)."""
        self.stream.compact(reason="rebalance")
        self._refresh()

    def search(self, res, queries, k: int, nprobe: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        from raft_tpu_torch.neighbors.ivf_mnmg import (merge_pool,
                                                       search_local,
                                                       search_mnmg)

        snap = self.stream.snapshot
        if nprobe >= snap.flat.n_lists:
            # the streaming layer owns the exact path (live rows only)
            return self.stream.search(queries, k, nprobe)
        self._refresh()
        index = self._mnmg
        if index.local is not None:
            return search_mnmg(res, index, queries, k, nprobe,
                               tomb_words=snap.tomb_words)
        queries = _on_device(queries, index.device)
        halves = [search_local(index, r, queries, k, nprobe,
                               tomb_words=snap.tomb_words)
                  for r in range(index.n_ranks)]
        return merge_pool(torch.stack([h[0] for h in halves]),
                          torch.stack([h[1] for h in halves]), k,
                          index.metric)
