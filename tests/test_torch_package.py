"""Package rules of the port (raft_tpu_torch): it imports neither jax
nor raft_tpu, every kernel in the registry has a plain version and a
parity test, entry points refuse to fall back from the card to the CPU,
and the environment knobs fail loudly."""

import ast
import ctypes
import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from raft_tpu_torch import kernels
from raft_tpu_torch.kernels import build

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "raft_tpu_torch"


def _run(code, **env):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120, env={**os.environ, **env})


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, raft_tpu_torch, raft_tpu_torch.cluster, "
            "raft_tpu_torch.distance, raft_tpu_torch.interop, "
            "raft_tpu_torch.matrix, raft_tpu_torch.neighbors, "
            "raft_tpu_torch.sparse, raft_tpu_torch.sparse.solver, "
            "raft_tpu_torch.spectral, raft_tpu_torch.random; "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'raft_tpu.')) or m == 'raft_tpu'))")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_port_file_imports_jax_or_reference(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "raft_tpu")]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("name", sorted(kernels.REGISTRY))
def test_registry_entry_is_complete(name):
    spec = kernels.REGISTRY[name]
    assert (PORT / spec.source).is_file()
    src = (PORT / spec.source).read_text()
    assert f'extern "C" int {spec.symbol}(' in src
    # the source names the TPU kernel it replaces
    assert spec.replaces.split(":")[-1] in src
    mod, _, attr = spec.plain.rpartition(".")
    assert callable(getattr(importlib.import_module(mod), attr))
    test_file, _, test_name = spec.parity_test.partition("::")
    assert f"def {test_name}(" in (REPO / test_file).read_text()
    ref_file, _, line = spec.replaces.partition(":")
    ref_line = (REPO / ref_file).read_text().splitlines()[int(line) - 1]
    assert ref_line.startswith("def _"), ref_line
    assert all(t in (ctypes.c_int, ctypes.c_int64, ctypes.c_void_p)
               for t in spec.argtypes)
    # one C parameter per declared argument type
    sig = re.search(rf"{spec.symbol}\(([^)]*)\)", src, re.S).group(1)
    assert sig.count(",") + 1 == len(spec.argtypes)


def test_launch_counts_reset_and_start_at_zero():
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {n: 0 for n in kernels.REGISTRY}


def test_cpu_tensors_never_count_a_launch():
    from raft_tpu_torch.linalg import contractions as tc
    from raft_tpu_torch.matrix import SelectAlgo, select_k
    from raft_tpu_torch.neighbors import knn

    kernels.reset_launch_counts()
    x = torch.randn(20, 5, generator=torch.Generator().manual_seed(0))
    tc.fused_lloyd_pallas(x, x[:3])
    tc.fused_l2_argmin_pallas(x, x[:3])
    tc.pairwise_l2_pallas(x, x[:3])
    knn(None, x, x[:3], 4)
    _sparse_calls_on_the_cpu()
    v = torch.randn(3, 9000, generator=torch.Generator().manual_seed(1))
    select_k(None, v, 40)                                   # radix
    select_k(None, v, 40, algo=SelectAlgo.WARPSORT_FILTERED)  # insert
    assert set(kernels.launch_counts().values()) == {0}


def _sparse_calls_on_the_cpu():
    """SpMV, SpMM, eigsh and a partition on CPU tensors."""
    import numpy as np
    import scipy.sparse as sp

    import raft_tpu_torch as rt
    from raft_tpu_torch.core.sparse_types import CSRMatrix
    from raft_tpu_torch.sparse import linalg
    from raft_tpu_torch.sparse.solver import eigsh
    from raft_tpu_torch.spectral import analyze_partition, partition

    res = rt.device_resources("cpu")
    blocks = sp.block_diag([np.ones((6, 6)) - np.eye(6)] * 2).tolil()
    blocks[0, 6] = blocks[6, 0] = 1.0
    g = CSRMatrix.from_scipy(sp.csr_matrix(blocks, dtype=np.float32),
                             res=res)
    linalg.spmv(g, torch.ones(12))
    linalg.spmm(g, torch.ones(12, 3))
    eigsh(g, k=2)
    labels, _, _ = partition(res, g, 2)
    analyze_partition(res, g, 2, labels)


def test_device_resources_refuses_cpu_fallback():
    import raft_tpu_torch as rt

    if torch.cuda.is_available():
        assert rt.device_resources().device == torch.device("cuda", 0)
        return
    with pytest.raises(rt.DeviceUnavailableError):
        rt.device_resources()
    with pytest.raises(rt.DeviceUnavailableError):
        rt.default_resources()
    res = rt.device_resources("cpu", seed=3)
    assert res.device.type == "cpu" and res.stream is None
    g1, g2 = res.generator(), res.generator()
    assert not torch.equal(torch.rand(4, generator=g1),
                           torch.rand(4, generator=g2))


@pytest.mark.parametrize("entry", ["pairwise_distance", "fused_l2_nn_argmin",
                                   "knn", "select_k", "radix_select_k",
                                   "insert_select", "knn_fused",
                                   "insert_drain_ref", "spmv", "spmm",
                                   "csr_from_scipy", "csr_from_numpy",
                                   "eigsh", "partition"])
def test_array_inputs_go_to_the_handle_device(entry):
    """An array with no handle goes to cuda:0: without CUDA that raises
    instead of running on the host; a CPU handle runs it here. The entry
    points that take no handle run on the host when given CPU tensors."""
    import numpy as np

    import raft_tpu_torch as rt
    from raft_tpu_torch.distance import fused_l2_nn_argmin, pairwise_distance
    from raft_tpu_torch.matrix import select_k
    from raft_tpu_torch.matrix.epilogue import insert_drain_ref
    from raft_tpu_torch.matrix.radix_select import radix_select_k
    from raft_tpu_torch.matrix.topk_insert import insert_select
    from raft_tpu_torch.neighbors import knn
    from raft_tpu_torch.neighbors.fused_topk import knn_fused

    import scipy.sparse as sp

    from raft_tpu_torch import interop
    from raft_tpu_torch.core.sparse_types import CSRMatrix
    from raft_tpu_torch.sparse import linalg
    from raft_tpu_torch.sparse.solver import eigsh
    from raft_tpu_torch.spectral import partition

    a = np.arange(24, dtype=np.float32).reshape(6, 4)
    ring = sp.csr_matrix(np.roll(np.eye(8, dtype=np.float32), 1, 1)
                         + np.roll(np.eye(8, dtype=np.float32), -1, 1))

    def arr(r, v=a):
        """No handle: the numpy array; a handle: a tensor on its device."""
        return v if r is None else torch.from_numpy(v).to(r.device)

    def csr(r):
        """The matrix on the handle's device (the CPU without CUDA)."""
        return CSRMatrix.from_scipy(ring, res=r or rt.device_resources(
            "cuda" if torch.cuda.is_available() else "cpu"))

    call = {"pairwise_distance": lambda r: pairwise_distance(r, a),
            "fused_l2_nn_argmin": lambda r: fused_l2_nn_argmin(r, a, a[:2]),
            "knn": lambda r: knn(r, a, a[:3], 2),
            "select_k": lambda r: select_k(r, a, 2),
            "radix_select_k": lambda r: radix_select_k(arr(r), 2),
            "insert_select": lambda r: insert_select(arr(r), 2),
            "knn_fused": lambda r: knn_fused(arr(r)[:3], arr(r), 2),
            "insert_drain_ref": lambda r: insert_drain_ref(arr(r), 2),
            "spmv": lambda r: linalg.spmv(csr(r), arr(r, a[:2].ravel())),
            "spmm": lambda r: linalg.spmm(csr(r), arr(r, a.reshape(8, 3))),
            "csr_from_scipy": lambda r: CSRMatrix.from_scipy(ring,
                                                             res=r).data,
            "csr_from_numpy": lambda r: interop.csr_from_numpy(
                ring.indptr, ring.indices, ring.data, ring.shape, res=r).data,
            "eigsh": lambda r: eigsh(ring.toarray(), k=2, res=r),
            "partition": lambda r: partition(r, ring, 2)}[entry]
    if torch.cuda.is_available():
        out = call(None)
        first = out[0] if isinstance(out, tuple) else out
        assert first.device == torch.device("cuda", 0)
        return
    with pytest.raises(rt.DeviceUnavailableError):
        call(None)
    out = call(rt.device_resources("cpu"))
    first = out[0] if isinstance(out, tuple) else out
    assert first.device.type == "cpu"


def test_malformed_precision_knob_fails_loudly():
    out = _run("import raft_tpu_torch.util.precision",
               RAFT_TPU_MATMUL_PRECISION="bogus")
    assert out.returncode != 0
    assert "RAFT_TPU_MATMUL_PRECISION" in out.stderr
    out = _run("import raft_tpu_torch.util.precision as p; "
               "print(p.current_mode())", RAFT_TPU_MATMUL_PRECISION="f32")
    assert out.returncode == 0 and out.stdout.strip() == "highest"


def test_precision_scope_pins_tf32_off():
    from raft_tpu_torch.util import precision as tprec

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with tprec.scope("default") as tier:
            assert tier == "default" == tprec.current_mode()
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
            with tprec.scope():
                assert tprec.current_mode() == "default"
        assert torch.backends.cuda.matmul.allow_tf32
        assert tprec.current_mode() == tprec.get_matmul_precision()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    with pytest.raises(ValueError):
        tprec.scope("tf32").__enter__()


def test_build_hash_tracks_sources_and_nvcc_is_required(tmp_path,
                                                        monkeypatch):
    spec = kernels.REGISTRY["fused_lloyd"]
    lib = build.library_path(spec)
    assert lib.parent == build.BUILD_DIR and lib.name.startswith(
        "fused_lloyd-")
    assert lib != build.library_path(kernels.REGISTRY["fused_argmin"])
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed here")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        build.find_nvcc()


def test_expect_finite_follows_the_guard_mode():
    from raft_tpu_torch.core.guards import NonFiniteError
    from raft_tpu_torch.util.input_validation import expect_2d, expect_finite

    bad = torch.tensor([[1.0, float("nan")]])
    expect_finite(bad, name="x")                     # 'off': no check
    expect_finite(bad, name="x", guard_mode="off")
    with pytest.raises(NonFiniteError) as e:
        expect_finite(bad, name="x", guard_mode="check")
    assert e.value.stage == "input"
    expect_finite(torch.ones(2, 2), name="x", guard_mode="recover")
    with pytest.raises(ValueError, match="expected 2-D"):
        expect_2d(torch.ones(3), name="x")
