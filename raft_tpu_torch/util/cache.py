"""Set-associative vector cache on the card (counterpart of
``raft_tpu/util/cache.py``; used to cache kernel-matrix columns in
SVM-style workloads).

Two tiers, as in the reference package:

- :class:`VectorCache`: host-driven. Lookups run on the device, slot
  assignment is a host loop between the caller's launches.
- :func:`device_cache_init` / :func:`device_cache_lookup` /
  :func:`device_cache_insert` over :class:`DeviceCacheState`: every step
  a few gathers and scatters on the state's device, with per-set
  pseudo-LRU victims from on-device timestamps.

The device tier updates the state's tensors in place and returns the
state: a state is threaded from call to call (as the reference's is
through ``jit`` and ``lax.scan``), and an earlier state object is not a
snapshot. Out-of-range slots stand in for the reference's dropped
scatters (``mode="drop"``) and clamped gathers: negative keys (the
empty-slot sentinel domain) go to a set index one past the end, which
gathers clamp and scatters discard. Where two rows of one insert batch
pick the same (set, way), the last row of the batch wins, on every
device (the reference leaves that winner unspecified; its CPU scatters
keep the last).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.mdarray import torch_dtype
from raft_tpu_torch.core.resources import (Resources, default_resources,
                                           get_device)

_INT32_MIN = -2 ** 31


def _on(x, device: torch.device, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``device``: a tensor elsewhere raises (the
    cache never moves a caller's tensor between devices), anything else
    is copied there."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"tensor on {x.device}, cache on {device}")
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)


class VectorCache:
    """Cache of ``n_vec``-long vectors addressed by integer keys, on the
    handle's device (``res``, ``cuda:0`` by default): ``get_vecs``,
    ``store_vecs``, ``get_cache_idx``, ``assign_cache_idx``. Capacity
    rounds down to a whole number of sets."""

    def __init__(self, n_vec: int, capacity: int, associativity: int = 32,
                 dtype=torch.float32, res: Optional[Resources] = None):
        if capacity <= 0:
            raise ValueError("cache capacity must be positive")
        dev = get_device(default_resources(res))
        self.n_vec = n_vec
        self.associativity = min(associativity, capacity)
        self.n_sets = max(1, capacity // self.associativity)
        self.capacity = self.n_sets * self.associativity
        self.keys = torch.full((self.capacity,), -1, dtype=torch.int32,
                               device=dev)
        self.time = torch.zeros((self.capacity,), dtype=torch.int32,
                                device=dev)
        self.store = torch.zeros((self.capacity, n_vec),
                                 dtype=torch_dtype(dtype), device=dev)
        self._clock = 0

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def _set_of(self, keys):
        return keys % self.n_sets

    def get_cache_idx(self, keys):
        """Each key's cache slot, or -1 on a miss. Hits refresh their
        slot's timestamp, so eviction is LRU."""
        keys = _on(keys, self.device, torch.int32)
        sets = self._set_of(keys)
        lanes = torch.arange(self.associativity, device=self.device)
        slot_ids = sets[:, None] * self.associativity + lanes[None, :]
        hit = self.keys[slot_ids] == keys[:, None]
        # the first matching lane (argmax of a bool picks the first True)
        lane = torch.argmax(hit.to(torch.int8), dim=1)
        idx = torch.where(hit.any(dim=1),
                          (sets * self.associativity + lane).to(torch.int32),
                          -1)
        hits = idx[idx >= 0]
        n_hits = int(hits.numel())
        if obs.enabled():
            if n_hits:
                obs.inc("cache_lookups_total", n_hits, cache="vector",
                        outcome="hit")
            misses = int(keys.shape[0]) - n_hits
            if misses:
                obs.inc("cache_lookups_total", misses, cache="vector",
                        outcome="miss")
        if n_hits:
            self._clock += 1
            self.time[hits.long()] = self._clock
        return idx

    def assign_cache_idx(self, keys):
        """Slots for (missing) keys, evicting each set's least recently
        used slot. Keys already cached, duplicates and same-set keys
        beyond the associativity get -1 (callers retry next round)."""
        keys_h = np.asarray(keys.cpu() if isinstance(keys, torch.Tensor)
                            else keys, np.int32)
        out = np.full(keys_h.shape, -1, np.int32)
        taken: dict = {}
        keys_dev = self.keys.cpu().numpy().copy()
        time_dev = self.time.cpu().numpy()
        seen = set(keys_dev[keys_dev >= 0].tolist())
        for i, k in enumerate(keys_h):
            k = int(k)
            if k in seen:
                continue
            s = k % self.n_sets
            base = s * self.associativity
            used = taken.setdefault(s, set())
            cand = [j for j in range(base, base + self.associativity)
                    if j not in used]
            if not cand:
                continue
            j = min(cand, key=lambda j: (keys_dev[j] >= 0, time_dev[j]))
            used.add(j)
            out[i] = j
            keys_dev[j] = k
            seen.add(k)
        self._clock += 1
        self.keys = torch.as_tensor(keys_dev, device=self.device)
        slots = torch.as_tensor(out[out >= 0], dtype=torch.long,
                                device=self.device)
        self.time[slots] = self._clock
        return torch.as_tensor(out, device=self.device)

    def store_vecs(self, vecs, cache_idx):
        """Write vectors into their assigned slots (rows with slot -1
        are skipped)."""
        vecs = _on(vecs, self.device)
        idx = _on(cache_idx, self.device).long()
        valid = torch.nonzero(idx >= 0)[:, 0]
        if valid.numel() == 0:
            return
        slots = idx[valid]
        self.store[slots] = vecs[valid].to(self.store.dtype)
        self._clock += 1
        self.time[slots] = self._clock

    def get_vecs(self, cache_idx):
        """The cached vectors of slot indices (slot -1 reads slot 0)."""
        idx = _on(cache_idx, self.device).long()
        return self.store[torch.where(idx >= 0, idx, 0)]

    def get_or_compute(self, keys, compute_fn):
        """Vectors for ``keys``, computing and caching the misses with
        ``compute_fn(missing_keys) -> [m, n_vec]``."""
        keys = _on(keys, self.device, torch.int32)
        idx = self.get_cache_idx(keys)
        miss_rows = torch.nonzero(idx < 0)[:, 0].cpu().numpy()
        fresh = None
        if miss_rows.size:
            missing = keys[torch.as_tensor(miss_rows, device=self.device)]
            fresh = compute_fn(missing)
            slots = self.assign_cache_idx(missing)
            self.store_vecs(fresh, slots)
            idx = self.get_cache_idx(keys)
        out = self.get_vecs(idx)
        still = torch.nonzero(idx < 0)[:, 0].cpu().numpy()
        if still.size:
            # a row still missing either lost an associativity conflict
            # in this batch (its vector is in `fresh`) or hit at first and
            # was evicted by this batch's assignments (recompute it)
            pos_in_miss = {int(k): i for i, k in enumerate(miss_rows)}
            reuse = [int(r) for r in still if int(r) in pos_in_miss]
            evicted = [int(r) for r in still if int(r) not in pos_in_miss]
            if reuse:
                rows = torch.as_tensor([pos_in_miss[r] for r in reuse],
                                       device=self.device)
                out[torch.as_tensor(reuse, device=self.device)] = \
                    fresh[rows].to(out.dtype)
            if evicted:
                ev = torch.as_tensor(evicted, device=self.device)
                out[ev] = compute_fn(keys[ev]).to(out.dtype)
        return out


class DeviceCacheState:
    """Cache state threaded from call to call. ``keys``/``time`` are
    (n_sets, assoc) int32 (-1 an empty slot), ``store`` (n_sets, assoc,
    n_vec), ``clock`` a 0-d int32 tensor, all on one device."""

    def __init__(self, keys, time, store, clock):
        self.keys = keys
        self.time = time
        self.store = store
        self.clock = clock

    @property
    def n_sets(self):
        return self.keys.shape[0]

    @property
    def associativity(self):
        return self.keys.shape[1]


def device_cache_init(n_vec: int, capacity: int, associativity: int = 32,
                      dtype=torch.float32,
                      res: Optional[Resources] = None) -> DeviceCacheState:
    """A fresh empty cache on the handle's device (``cuda:0`` by
    default). Capacity rounds UP to a whole number of sets (the
    reference's rule here, where :class:`VectorCache` rounds down). Keys
    must be non-negative: lookups of negative keys miss and inserts of
    them are dropped."""
    if capacity <= 0:
        raise ValueError("cache capacity must be positive")
    dev = get_device(default_resources(res))
    assoc = min(associativity, capacity)
    n_sets = max(1, -(-capacity // assoc))
    return DeviceCacheState(
        keys=torch.full((n_sets, assoc), -1, dtype=torch.int32, device=dev),
        time=torch.zeros((n_sets, assoc), dtype=torch.int32, device=dev),
        store=torch.zeros((n_sets, assoc, n_vec), dtype=torch_dtype(dtype),
                          device=dev),
        clock=torch.zeros((), dtype=torch.int32, device=dev))


def _cache_set_of(keys, n_sets):
    """(valid, set index) with negative keys at the out-of-range set
    ``n_sets``: gathers clamp it, scatters drop it."""
    valid = keys >= 0
    return valid, torch.where(valid, keys % n_sets, n_sets)


def _writers(valid, slot):
    """Scatter targets with no conflicting writers, and no host sync:
    valid rows keep their flat ``slot``, the others join the first valid
    row's slot (and write what its winner writes); with no valid row at
    all every row targets slot 0 and rewrites its current value
    (``any_valid`` False)."""
    first = torch.argmax(valid.to(torch.int8))
    any_valid = valid.any()
    tgt = torch.where(valid, slot, slot[first])
    return torch.where(any_valid, tgt, torch.zeros_like(tgt)), any_valid


def device_cache_lookup(state: DeviceCacheState, keys):
    """Batched lookup: ``(vecs [B, n_vec], hit [B] bool, state)``. Hits
    refresh their slot's timestamp; missed rows return zeros."""
    keys = _on(keys, state.keys.device, torch.int32)
    valid, s = _cache_set_of(keys, state.n_sets)
    sc = torch.clamp(s, max=state.n_sets - 1)
    match = (state.keys[sc] == keys[:, None]) & valid[:, None]
    hit = match.any(dim=1)
    way = torch.argmax(match.to(torch.int8), dim=1)
    vecs = torch.where(hit[:, None], state.store[sc, way],
                       torch.zeros((), dtype=state.store.dtype,
                                   device=keys.device))
    state.clock += 1
    if keys.shape[0]:
        time = state.time.view(-1)
        tgt, any_hit = _writers(hit, sc.long() * state.associativity + way)
        time[tgt] = torch.where(any_hit, state.clock, time[0]).expand(
            tgt.shape)
    return vecs, hit, state


def device_cache_insert(state: DeviceCacheState, keys, vecs
                        ) -> DeviceCacheState:
    """Insert or overwrite a batch; returns the state. Each row's victim
    is the key's own slot where present, else its set's LRU way (empty
    ways first, the first such way on ties). Keys in a batch should be
    distinct; where two rows pick the same (set, way), the later row's
    key and vector win. Negative keys are dropped."""
    dev = state.keys.device
    keys = _on(keys, dev, torch.int32)
    vecs = _on(vecs, dev)
    n_sets, assoc = state.n_sets, state.associativity
    valid, s = _cache_set_of(keys, n_sets)
    sc = torch.clamp(s, max=n_sets - 1)
    set_keys = state.keys[sc]
    match = set_keys == keys[:, None]
    present = match.any(dim=1)
    hit_way = torch.argmax(match.to(torch.int8), dim=1)
    set_time = torch.where(set_keys < 0,
                           torch.full((), _INT32_MIN, dtype=torch.int32,
                                      device=dev),
                           state.time[sc])
    lru_way = torch.argmin(set_time, dim=1)
    way = torch.where(present, hit_way, lru_way)
    state.clock += 1
    if not keys.shape[0]:
        return state
    # one value a slot: the batch's last row aimed at it wins
    slot = torch.where(valid, sc.long() * assoc + way, n_sets * assoc)
    row = torch.arange(keys.shape[0], device=dev)
    last = torch.full((n_sets * assoc + 1,), -1, dtype=torch.long,
                      device=dev).scatter_reduce_(0, slot, row, "amax")
    tgt, any_valid = _writers(valid, slot)
    src = last[tgt].clamp(min=0)
    flat_keys = state.keys.view(-1)
    flat_time = state.time.view(-1)
    flat_store = state.store.view(n_sets * assoc, -1)
    flat_keys[tgt] = torch.where(any_valid, keys[src], flat_keys[0])
    flat_time[tgt] = torch.where(any_valid, state.clock,
                                 flat_time[0]).expand(tgt.shape)
    flat_store[tgt] = torch.where(any_valid, vecs[src].to(state.store.dtype),
                                  flat_store[0])
    return state
