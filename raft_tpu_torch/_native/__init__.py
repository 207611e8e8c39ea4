"""The native host runtime: ``raft_tpu_native.cpp`` built with g++ at
first use and bound with ``ctypes``.

The library is built into ``build/native/`` beside the package (listed
in ``.gitignore``), named by a hash of the source and the flags, so an
edited source is never served by a stale library; concurrent builds
each write their own temporary file and rename it into place.

Where no toolchain exists the import still succeeds:
:func:`native_available` reports False and :func:`build_error` keeps
the reason.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "raft_tpu_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lib = None        # None: not tried; False: the build failed; else the CDLL
_lib_err: str = ""
_lock = threading.Lock()


def build_command(src: str, out: str) -> list:
    """The g++ invocation (the reference package's flags)."""
    return ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
            "-fvisibility=hidden", "-pthread", src, "-o", out]


def source_digest() -> str:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(build_command("", "")).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libraft_tpu_native_{source_digest()}.so"


def _build_and_load():
    global _lib_err
    so_path = library_path()
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_name(f"{so_path.name}.tmp{os.getpid()}")
        try:
            subprocess.run(build_command(str(_SRC), str(tmp)), check=True,
                           capture_output=True, text=True, timeout=300)
            os.replace(tmp, so_path)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
                FileNotFoundError) as e:
            _lib_err = getattr(e, "stderr", None) or str(e)
            with contextlib.suppress(OSError):
                tmp.unlink()
            return None
    try:
        lib = ctypes.CDLL(str(so_path))
        _bind(lib)
    except (OSError, AttributeError) as e:
        # a damaged library: drop it so the next process rebuilds
        _lib_err = str(e)
        with contextlib.suppress(OSError):
            so_path.unlink()
        return None
    _lib_err = ""
    return lib


def _bind(lib):
    c = ctypes
    lib.rt_pool_create.restype = c.c_void_p
    lib.rt_pool_create.argtypes = [c.c_int]
    lib.rt_pool_destroy.restype = None
    lib.rt_pool_destroy.argtypes = [c.c_void_p]
    lib.rt_pool_alloc.restype = c.c_void_p
    lib.rt_pool_alloc.argtypes = [c.c_void_p, c.c_int64]
    lib.rt_pool_dealloc.restype = c.c_int
    lib.rt_pool_dealloc.argtypes = [c.c_void_p, c.c_void_p]
    lib.rt_pool_stats.restype = None
    lib.rt_pool_stats.argtypes = [c.c_void_p, c.POINTER(c.c_int64)]
    lib.rt_pool_set_notify.restype = None
    lib.rt_pool_set_notify.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p]
    lib.rt_monitor_start.restype = c.c_void_p
    lib.rt_monitor_start.argtypes = [c.c_void_p, c.c_char_p, c.c_int]
    lib.rt_monitor_set_tag.restype = None
    lib.rt_monitor_set_tag.argtypes = [c.c_void_p, c.c_char_p]
    lib.rt_monitor_stop.restype = None
    lib.rt_monitor_stop.argtypes = [c.c_void_p]
    lib.rt_interruptible_cancel.restype = None
    lib.rt_interruptible_cancel.argtypes = [c.c_int64]
    lib.rt_interruptible_check.restype = c.c_int
    lib.rt_interruptible_check.argtypes = [c.c_int64]
    lib.rt_interruptible_cancelled.restype = c.c_int
    lib.rt_interruptible_cancelled.argtypes = [c.c_int64]
    lib.rt_npy_write.restype = c.c_int
    lib.rt_npy_write.argtypes = [c.c_char_p, c.c_char_p,
                                 c.POINTER(c.c_int64), c.c_int, c.c_void_p,
                                 c.c_int64]
    lib.rt_npy_read_header.restype = c.c_int64
    lib.rt_npy_read_header.argtypes = [c.c_char_p, c.c_char_p,
                                       c.POINTER(c.c_int64),
                                       c.POINTER(c.c_int),
                                       c.POINTER(c.c_int)]
    lib.rt_npy_read_data.restype = c.c_int
    lib.rt_npy_read_data.argtypes = [c.c_char_p, c.c_int64, c.c_void_p,
                                     c.c_int64]
    lib.rt_threadpool_create.restype = c.c_void_p
    lib.rt_threadpool_create.argtypes = [c.c_int]
    lib.rt_threadpool_destroy.restype = None
    lib.rt_threadpool_destroy.argtypes = [c.c_void_p]
    lib.rt_threadpool_memcpy.restype = None
    lib.rt_threadpool_memcpy.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                         c.c_int64, c.c_int64]
    lib.rt_threadpool_submit.restype = None
    lib.rt_threadpool_submit.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p]
    lib.rt_threadpool_wait.restype = None
    lib.rt_threadpool_wait.argtypes = [c.c_void_p]
    lib.rt_version.restype = c.c_int
    lib.rt_version.argtypes = []


def get_lib():
    """The loaded library, built if need be; None where it cannot be
    built (the reason in :func:`build_error`). A failed build is tried
    once a process."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _build_and_load() or False
    return _lib or None


def native_available() -> bool:
    return get_lib() is not None


def build_error() -> str:
    return _lib_err
