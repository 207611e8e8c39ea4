"""Wrappers over the native host runtime (counterpart of
``raft_tpu/core/native_runtime.py``; the library is
``raft_tpu_torch/_native/raft_tpu_native.cpp``):

- :class:`TrackedHostPool`: a statistics-tracking host allocator,
  optionally mmap-backed, with a notify hook;
- :class:`NativeResourceMonitor`: a background sampler writing the
  pool's statistics to CSV, rows tagged;
- :func:`npy_save` / :func:`npy_load`: the native ``.npy`` writer and
  reader, byte for byte ``core/serialize``'s format;
- :class:`NativeThreadPool`: a host worker pool for chunked copies;
- :func:`native_cancel` / :func:`native_check_cancelled`: the native
  token registry of ``core/interruptible``.

Where ``_native.native_available()`` is False (no g++), the pool,
monitor and thread pool raise with the build error, and the ``.npy``
and cancellation functions use numpy and ``core/interruptible``.
"""

from __future__ import annotations

import ctypes
import threading
import weakref
from typing import Optional

import numpy as np

from raft_tpu_torch import _native
from raft_tpu_torch.core import serialize

_DESCR = {
    np.dtype("float32"): "<f4", np.dtype("float64"): "<f8",
    np.dtype("int32"): "<i4", np.dtype("int64"): "<i8",
    np.dtype("int16"): "<i2", np.dtype("int8"): "|i1",
    np.dtype("uint8"): "|u1", np.dtype("uint32"): "<u4",
    np.dtype("uint64"): "<u8", np.dtype("bool"): "|b1",
}
_DESCR_INV = {v: k for k, v in _DESCR.items()}


def native_available() -> bool:
    return _native.native_available()


def _lib_or_raise():
    lib = _native.get_lib()
    if lib is None:
        raise RuntimeError(
            f"native runtime unavailable: {_native.build_error()}")
    return lib


class TrackedHostPool:
    """Statistics-tracking host allocator (optionally mmap-backed).

    Hands out numpy arrays backed by native allocations, freed on
    :meth:`release`, when the last view of one is collected, or when the
    pool closes."""

    def __init__(self, use_mmap: bool = False):
        self._lib = _lib_or_raise()
        self._pool = self._lib.rt_pool_create(1 if use_mmap else 0)
        # allocation base address -> (ptr, weakref.finalize)
        self._ptrs: dict = {}
        self._cb = None            # keeps the ctypes callback alive
        self._lock = threading.Lock()
        # finalizers read this cell, so an array collected after close()
        # never touches the destroyed pool
        self._alive = {"pool": self._pool, "lib": self._lib}

    def allocate(self, shape, dtype=np.float32) -> np.ndarray:
        dtype = np.dtype(dtype)
        count = int(np.prod(shape))
        if count == 0:
            return np.empty(shape, dtype)
        nbytes = count * dtype.itemsize
        ptr = self._lib.rt_pool_alloc(self._pool, nbytes)
        if not ptr:
            raise MemoryError(f"native pool allocation of {nbytes}B failed")
        flat = np.frombuffer((ctypes.c_char * nbytes).from_address(ptr),
                             dtype=dtype)
        alive, lock, ptrs = self._alive, self._lock, self._ptrs

        def _finalize(addr=ptr):
            with lock:
                entry = ptrs.pop(addr, None)
            if entry is not None and alive["pool"]:
                alive["lib"].rt_pool_dealloc(alive["pool"], addr)

        # on the frombuffer base: every view keeps it alive through .base
        fin = weakref.finalize(flat, _finalize)
        fin.atexit = False
        with self._lock:
            self._ptrs[ptr] = (ptr, fin)
        return flat.reshape(shape)

    def release(self, arr: np.ndarray) -> None:
        """Free an array returned by :meth:`allocate`; a view or a copy
        raises."""
        if arr.size == 0:
            return
        addr = arr.__array_interface__["data"][0]
        with self._lock:
            entry = self._ptrs.pop(addr, None)
        if entry is None:
            raise ValueError(
                "release() got an array this pool did not allocate (or a "
                "view offset from the allocation base)")
        ptr, fin = entry
        fin.detach()
        self._lib.rt_pool_dealloc(self._pool, ptr)

    def stats(self) -> dict:
        out = (ctypes.c_int64 * 4)()
        self._lib.rt_pool_stats(self._pool, out)
        return {"bytes_allocated": out[0], "peak_bytes": out[1],
                "n_allocations": out[2], "n_deallocations": out[3]}

    def set_notify(self, fn) -> None:
        """Observer hook ``fn(is_alloc: bool, nbytes: int)``; None
        removes it."""
        if fn is None:
            with self._lock:
                self._cb = None
            self._lib.rt_pool_set_notify(self._pool, None, None)
            return
        cb_t = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_int64,
                                ctypes.c_void_p)
        cb = cb_t(lambda is_alloc, nbytes, _:
                  fn(bool(is_alloc), int(nbytes)))
        with self._lock:
            self._cb = cb
        self._lib.rt_pool_set_notify(
            self._pool, ctypes.cast(cb, ctypes.c_void_p), None)

    def close(self) -> None:
        if getattr(self, "_pool", None):
            with self._lock:
                for _, fin in self._ptrs.values():
                    fin.detach()   # destroying the pool frees them all
                self._ptrs.clear()
                self._alive["pool"] = None
                pool, self._pool = self._pool, None
            self._lib.rt_pool_destroy(pool)

    def __del__(self):
        # at interpreter exit module globals may already be gone
        try:
            self.close()
        except Exception:
            pass


class NativeResourceMonitor:
    """Background sampler writing a pool's statistics to CSV, each row
    tagged with the tag last set."""

    def __init__(self, pool: TrackedHostPool, csv_path: str,
                 interval_ms: int = 50):
        self._lib = _lib_or_raise()
        # the sampler thread reads the pool's native state: hold the pool
        self._pool_ref = pool
        self._mon = self._lib.rt_monitor_start(
            pool._pool, csv_path.encode(), interval_ms)
        if not self._mon:
            raise RuntimeError(f"cannot open {csv_path}")

    def set_tag(self, tag: str) -> None:
        self._lib.rt_monitor_set_tag(self._mon, tag.encode())

    def stop(self) -> None:
        if self._mon:
            self._lib.rt_monitor_stop(self._mon)
            self._mon = None
            self._pool_ref = None


def npy_save(path: str, arr) -> None:
    """Native ``.npy`` writer: an array or tensor (host or device),
    written in C order. Bytes equal :func:`raft_tpu_torch.core.serialize.
    dumps` of a C-ordered array; a dtype the native writer does not
    name (bf16's wire dtype, float16) is written by numpy."""
    lib = _native.get_lib()
    # np.require keeps a 0-d array 0-d (ascontiguousarray makes it 1-d)
    arr = np.require(serialize.host_array(arr), requirements="C")
    descr = _DESCR.get(arr.dtype)
    if lib is None or descr is None:
        # a file object, so np.save cannot append ".npy" to the path
        with open(path, "wb") as f:
            np.save(f, arr, allow_pickle=False)
        return
    shape = (ctypes.c_int64 * max(arr.ndim, 1))(*arr.shape)
    rc = lib.rt_npy_write(path.encode(), descr.encode(), shape, arr.ndim,
                          arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes)
    if rc != 0:
        raise IOError(f"native npy write failed with code {rc}")


def npy_load(path: str) -> np.ndarray:
    """Native ``.npy`` reader (numpy for a dtype it does not name)."""
    lib = _native.get_lib()
    if lib is None:
        return np.load(path, allow_pickle=False)
    descr = ctypes.create_string_buffer(16)
    shape = (ctypes.c_int64 * 32)()
    ndim = ctypes.c_int(0)
    fortran = ctypes.c_int(0)
    off = lib.rt_npy_read_header(path.encode(), descr, shape,
                                 ctypes.byref(ndim), ctypes.byref(fortran))
    if off < 0:
        raise IOError(f"native npy header parse failed with code {off}")
    dtype = _DESCR_INV.get(descr.value.decode())
    if dtype is None:
        return np.load(path, allow_pickle=False)
    shp = tuple(shape[i] for i in range(ndim.value))
    out = np.empty(shp, dtype)
    rc = lib.rt_npy_read_data(path.encode(), off,
                              out.ctypes.data_as(ctypes.c_void_p),
                              out.nbytes)
    if rc != 0:
        raise IOError(f"native npy read failed with code {rc}")
    if fortran.value:
        # column-major bytes: reinterpret, keeping the shape
        out = out.reshape(shp[::-1]).T
    return out


class NativeThreadPool:
    """Host worker pool for chunked copies and IO."""

    def __init__(self, n_threads: int = 0):
        self._lib = _lib_or_raise()
        self._tp = self._lib.rt_threadpool_create(n_threads)

    def parallel_copy(self, dst: np.ndarray, src: np.ndarray,
                      chunk_bytes: int = 8 << 20) -> None:
        """``dst[...] = src`` byte for byte, in ``chunk_bytes`` pieces
        over the pool's threads."""
        if dst.nbytes != src.nbytes:
            raise ValueError("size mismatch")
        if not dst.flags["C_CONTIGUOUS"]:
            raise ValueError(
                "dst must be C-contiguous: the native memcpy writes a flat "
                "byte range and would corrupt a strided view's base buffer")
        src = np.ascontiguousarray(src)
        self._lib.rt_threadpool_memcpy(
            self._tp, dst.ctypes.data_as(ctypes.c_void_p),
            src.ctypes.data_as(ctypes.c_void_p), dst.nbytes, chunk_bytes)

    def close(self) -> None:
        if getattr(self, "_tp", None):
            self._lib.rt_threadpool_destroy(self._tp)
            self._tp = None

    def __del__(self):
        # at interpreter exit module globals may already be gone
        try:
            self.close()
        except Exception:
            pass


def native_cancel(thread_id: Optional[int] = None) -> None:
    """Cancel ``thread_id``'s token (the calling thread's by default) in
    the native registry; ``core/interruptible``'s without a toolchain."""
    lib = _native.get_lib()
    tid = thread_id if thread_id is not None else threading.get_ident()
    if lib is None:
        from raft_tpu_torch.core import interruptible

        interruptible.cancel(tid)
        return
    lib.rt_interruptible_cancel(tid)


def native_check_cancelled(thread_id: Optional[int] = None) -> bool:
    """Whether ``thread_id``'s token was cancelled, consuming the flag;
    ``core/interruptible``'s registry without a toolchain."""
    lib = _native.get_lib()
    tid = thread_id if thread_id is not None else threading.get_ident()
    if lib is None:
        from raft_tpu_torch.core import interruptible

        token = interruptible.get_token(tid)
        cancelled = token.cancelled()
        if cancelled:
            token.clear()
        return cancelled
    return bool(lib.rt_interruptible_check(tid))
