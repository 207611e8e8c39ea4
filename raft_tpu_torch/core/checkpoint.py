"""Versioned, CRC-checked solver checkpoints (counterpart of
``raft_tpu/core/checkpoint.py``).

The container is the reference package's v1 format, byte for byte, so
each package reads the other's files:

    magic    8s   b"RAFTCKP1"
    version  u32  (currently 1)
    n        u32  entry count
    entry*n:
      name_len u16, name utf-8
      kind     u8   (0 = array, 1 = scalar, 2 = rng state)
      nbytes   u64
      payload  nbytes   (.npy bytes)
      crc32    u32      (of payload)

Every entry's payload is a NumPy ``.npy`` stream written by
:mod:`raft_tpu_torch.core.serialize`. A bf16 array travels as the
one-field structured dtype ``[("bfloat16", "<u2")]`` (the reference's
wire form; NumPy has no bf16 of its own) and reads back as a
``torch.bfloat16`` tensor. Other arrays read
back as NumPy arrays, scalars as native Python values, and an
:class:`~raft_tpu_torch.random.rng_state.RngState` as itself.

Writes are atomic (``<path>.tmp``, fsync, ``os.replace``), so a writer
killed mid-save leaves the previous checkpoint whole.
:class:`CheckpointManager` keeps step-indexed files with retention;
elastic recovery resumes from its ``restore_latest()``.
"""

from __future__ import annotations

import io
import os
import re
import struct
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from raft_tpu_torch import obs
from raft_tpu_torch.core import logger, serialize, trace
from raft_tpu_torch.random.rng_state import GeneratorType, RngState

_log = logger.child("checkpoint")

MAGIC = b"RAFTCKP1"
VERSION = 1

_KIND_ARRAY = 0
_KIND_SCALAR = 1
_KIND_RNGSTATE = 2

_HEADER = struct.Struct("<8sII")          # magic, version, n_entries
_ENTRY_HEAD = struct.Struct("<H")         # name length
_ENTRY_META = struct.Struct("<BQ")        # kind, payload nbytes
_ENTRY_CRC = struct.Struct("<I")          # crc32 of payload

class CheckpointError(RuntimeError):
    """Base error for checkpoint reading/writing."""


class CheckpointCorruptError(CheckpointError):
    """The container is structurally damaged (bad magic, truncation, or
    a CRC mismatch on an entry)."""


class CheckpointVersionError(CheckpointError):
    """The container is a different format version than this reader."""


def _encode_value(value: Any) -> Tuple[int, bytes]:
    if isinstance(value, RngState):
        triple = np.asarray(
            [value.seed, value.base_subsequence,
             0 if value.type == GeneratorType.THREEFRY else 1], np.int64)
        return _KIND_RNGSTATE, serialize.dumps(triple)
    if isinstance(value, (bool, int, float, complex, np.generic)):
        return _KIND_SCALAR, serialize.dumps(np.asarray(value))
    return _KIND_ARRAY, serialize.dumps(value)


def _decode_value(kind: int, payload: bytes) -> Any:
    if kind == _KIND_RNGSTATE:
        triple = serialize.loads(payload, to_device=False)
        return RngState(
            seed=int(triple[0]), base_subsequence=int(triple[1]),
            type=(GeneratorType.THREEFRY if int(triple[2]) == 0
                  else GeneratorType.RBG))
    if kind == _KIND_SCALAR:
        return serialize.deserialize_scalar(None, io.BytesIO(payload))
    if kind == _KIND_ARRAY:
        return serialize.loads(payload, to_device=False)
    raise CheckpointCorruptError(f"unknown entry kind {kind}")


def dump_checkpoint(entries: Dict[str, Any], stream) -> None:
    """Serialize ``entries`` (name → array | tensor | scalar | RngState)
    into ``stream`` in the v1 container layout."""
    stream.write(_HEADER.pack(MAGIC, VERSION, len(entries)))
    for name, value in entries.items():
        raw_name = name.encode("utf-8")
        if len(raw_name) > 0xFFFF:
            raise ValueError(f"entry name too long: {name[:40]!r}…")
        kind, payload = _encode_value(value)
        stream.write(_ENTRY_HEAD.pack(len(raw_name)))
        stream.write(raw_name)
        stream.write(_ENTRY_META.pack(kind, len(payload)))
        stream.write(payload)
        stream.write(_ENTRY_CRC.pack(zlib.crc32(payload)))


def _read_exact(stream, n: int) -> bytes:
    buf = stream.read(n)
    if len(buf) != n:
        raise CheckpointCorruptError(
            f"truncated checkpoint: wanted {n} bytes, got {len(buf)}")
    return buf


def load_checkpoint(stream) -> Dict[str, Any]:
    """Parse a v1 container; every entry's CRC is verified before its
    payload is decoded."""
    magic, version, n = _HEADER.unpack(_read_exact(stream, _HEADER.size))
    if magic != MAGIC:
        raise CheckpointCorruptError(
            f"bad magic {magic!r} (want {MAGIC!r}) — not a raft_tpu "
            "checkpoint")
    if version != VERSION:
        raise CheckpointVersionError(
            f"checkpoint format v{version}, this reader is v{VERSION}")
    out: Dict[str, Any] = {}
    for _ in range(n):
        (name_len,) = _ENTRY_HEAD.unpack(
            _read_exact(stream, _ENTRY_HEAD.size))
        name = _read_exact(stream, name_len).decode("utf-8")
        kind, nbytes = _ENTRY_META.unpack(
            _read_exact(stream, _ENTRY_META.size))
        payload = _read_exact(stream, nbytes)
        (crc,) = _ENTRY_CRC.unpack(_read_exact(stream, _ENTRY_CRC.size))
        if zlib.crc32(payload) != crc:
            raise CheckpointCorruptError(
                f"entry {name!r}: crc mismatch — checkpoint damaged")
        out[name] = _decode_value(kind, payload)
    return out


def save_checkpoint(path: Union[str, os.PathLike],
                    entries: Dict[str, Any], *,
                    pre_replace: Optional[Any] = None) -> None:
    """Atomically write ``entries`` to ``path``: the bytes land in
    ``<path>.tmp``, are flushed and fsynced, and only then renamed into
    place, so readers only ever see complete checkpoints.
    ``pre_replace`` (a zero-argument callable) runs between the fsync and
    the rename: a crash inside it leaves only ``.tmp`` debris."""
    path = os.fspath(path)
    tmp = path + ".tmp"
    t0 = time.monotonic()
    with open(tmp, "wb") as f:
        dump_checkpoint(entries, f)
        f.flush()
        os.fsync(f.fileno())
        nbytes = f.tell()
    if pre_replace is not None:
        pre_replace()
    os.replace(tmp, path)
    if obs.enabled():
        obs.inc("checkpoint_bytes_written_total", nbytes)
        obs.observe("checkpoint_write_seconds", time.monotonic() - t0)
    trace.record_event("checkpoint.save", path=path, entries=len(entries))


def restore_checkpoint(path: Union[str, os.PathLike]) -> Dict[str, Any]:
    path = os.fspath(path)
    with open(path, "rb") as f:
        out = load_checkpoint(f)
    trace.record_event("checkpoint.restore", path=path, entries=len(out))
    return out


class CheckpointManager:
    """Step-indexed checkpoint files with retention.

    Files are ``<directory>/<prefix>-<step:08d>.ckpt``; ``save`` writes
    atomically and prunes to the newest ``keep`` files; ``latest()``
    returns (step, path) of the newest checkpoint, which is what elastic
    recovery resumes from.
    """

    def __init__(self, directory: Union[str, os.PathLike],
                 prefix: str = "ckpt", keep: int = 2):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.directory = os.fspath(directory)
        self.prefix = prefix
        self.keep = int(keep)
        os.makedirs(self.directory, exist_ok=True)
        self._pat = re.compile(re.escape(prefix) + r"-(\d{8})\.ckpt$")

    def path_for(self, step: int) -> str:
        return os.path.join(self.directory,
                            f"{self.prefix}-{int(step):08d}.ckpt")

    def save(self, step: int, entries: Dict[str, Any], *,
             pre_replace: Optional[Any] = None) -> str:
        path = self.path_for(step)
        save_checkpoint(path, entries, pre_replace=pre_replace)
        self._prune()
        return path

    def verify(self, step: int) -> None:
        """Parse the step's file end to end (every entry's CRC checked),
        raising the :class:`CheckpointError` types on damage."""
        restore_checkpoint(self.path_for(step))

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = self._pat.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[Tuple[int, str]]:
        steps = self.steps()
        if not steps:
            return None
        return steps[-1], self.path_for(steps[-1])

    def restore_latest(self) -> Optional[Tuple[int, Dict[str, Any]]]:
        latest = self.latest()
        if latest is None:
            return None
        step, path = latest
        return step, restore_checkpoint(path)

    def _prune(self) -> None:
        for step in self.steps()[:-self.keep]:
            path = self.path_for(step)
            try:
                os.remove(path)
            except OSError as e:
                _log.warning("retention prune of %s failed: %r", path, e)
