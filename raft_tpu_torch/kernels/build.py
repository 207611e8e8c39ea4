"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<kernel>.cu`` compiles on its own into a shared library with
a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<kernel>-<hash>.so csrc/<kernel>.cu

into ``build/kernels/`` beside the package (listed in ``.gitignore``).
The file name carries a hash of the sources and flags, so an edited
source is never served by a stale library. :func:`build` starts one
``nvcc`` per missing library, all at once, and waits for them; a failed
compile raises :class:`KernelBuildError` with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
COMMON_HEADER = PACKAGE_DIR / "csrc" / "common.cuh"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_entry_points: Dict[str, object] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the CUDA
    toolkit's standard install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on the PATH); the CUDA "
        "kernels are built from raft_tpu_torch/csrc at first use")


def library_path(spec) -> Path:
    src = PACKAGE_DIR / spec.source
    h = hashlib.sha256()
    for part in (src.read_bytes(), COMMON_HEADER.read_bytes(),
                 " ".join(NVCC_FLAGS).encode()):
        h.update(part)
    return BUILD_DIR / f"{spec.name}-{h.hexdigest()[:16]}.so"


def build(specs: Optional[Iterable] = None) -> Dict[str, dict]:
    """Compile every kernel in ``specs`` (default: all) whose library is
    missing, one ``nvcc`` process each, all started together. Returns
    ``{name: {"seconds": wall time, "log": compiler output, "cached":
    bool}}``; raises :class:`KernelBuildError` if any compile fails."""
    from raft_tpu_torch.kernels import REGISTRY

    specs = list(REGISTRY.values()) if specs is None else list(specs)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, dict] = {}
    running = []
    t0 = time.perf_counter()
    for spec in specs:
        lib = library_path(spec)
        if lib.is_file():
            out[spec.name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(PACKAGE_DIR / spec.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((spec, lib, tmp, proc))
    failures = []
    for spec, lib, tmp, proc in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{spec.source} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        out[spec.name] = {"seconds": seconds, "log": log, "cached": False}
    if failures:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failures))
    return out


def entry_point(spec):
    """Load ``spec``'s library (building it if missing) and return its C
    entry point with ``argtypes``/``restype`` declared."""
    with _lock:
        fn = _entry_points.get(spec.name)
        if fn is None:
            lib = library_path(spec)
            if not lib.is_file():
                build([spec])
            fn = getattr(ctypes.CDLL(str(lib)), spec.symbol)
            fn.argtypes = list(spec.argtypes)
            fn.restype = ctypes.c_int
            _entry_points[spec.name] = fn
        return fn
