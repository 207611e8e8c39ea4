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
            "raft_tpu_torch.sparse.solver.mst, "
            "raft_tpu_torch.sparse.solver.mst_grid, "
            "raft_tpu_torch.neighbors.fused_topk, "
            "raft_tpu_torch.linalg.contractions, "
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


LINALG_ENTRIES = [
    "gemm", "gemv", "axpy", "dot", "transpose", "scal", "mean_squared_error",
    "add", "add_scalar", "subtract", "subtract_scalar", "multiply",
    "multiply_scalar", "divide", "divide_scalar", "power", "power_scalar",
    "sqrt", "unary_op", "write_only_unary_op", "binary_op", "ternary_op",
    "map", "map_offset", "map_reduce", "map_then_reduce", "reduce",
    "coalesced_reduction", "strided_reduction", "reduce_rows_by_key",
    "reduce_cols_by_key", "matrix_vector_op", "norm", "row_norm",
    "col_norm", "normalize", "eig_dc", "eig_jacobi", "eig_sel", "qr_get_q",
    "qr_get_qr", "svd_qr", "svd_eig", "svd_jacobi", "svd_reconstruction",
    "rsvd_fixed_rank", "rsvd_perc", "lstsq_svd_qr", "lstsq_svd_jacobi",
    "lstsq_eig", "lstsq_qr", "cholesky_r1_update", "pca_fit",
    "pca_transform", "pca_inverse_transform", "pca_fit_transform",
    "pca_partial_fit", "pca_finalize", "tsvd_fit", "tsvd_transform",
    "tsvd_inverse_transform", "tsvd_fit_transform", "cal_eig",
    "sign_flip_components", "make_kvp"]


def _linalg_call(entry, r, arr):
    """A call of a dense linalg entry point on small arrays (numpy with
    no handle, as ``arr`` gives them for those that take none)."""
    import numpy as np

    from raft_tpu_torch import device_resources
    from raft_tpu_torch import linalg as tl
    from raft_tpu_torch.core import kvp

    g = np.random.default_rng(0).normal(size=(6, 4)).astype(np.float32)
    sq = g.T @ g + np.eye(4, dtype=np.float32)
    keys = np.array([0, 1, 0, 2, 1, 0], np.int32)
    cpu = device_resources("cpu")
    fit = tl.pca_fit(cpu, torch.from_numpy(g), 2)
    tfit = tl.tsvd_fit(cpu, torch.from_numpy(g), 2)
    add = lambda x, y: x + y          # noqa: E731
    state = tl.IncrementalPCAState(g.mean(0), sq, np.float32(6.0))
    two = {"gemm": (g.T, g), "add": (g, g), "subtract": (g, g),
           "multiply": (g, g), "divide": (g, g + 9), "power": (g, g),
           "mean_squared_error": (g, g)}
    if entry in two:
        return getattr(tl, entry)(r, *two[entry])
    if entry.endswith("_scalar"):
        return getattr(tl, entry)(r, g, 2.0)
    return {
        "gemv": lambda: tl.gemv(r, g, g[0]),
        "axpy": lambda: tl.axpy(r, 2.0, g, g),
        "dot": lambda: tl.dot(r, g[0], g[1]),
        "transpose": lambda: tl.transpose(r, g),
        "scal": lambda: tl.scal(r, 2.0, g),
        "sqrt": lambda: tl.sqrt(r, sq),
        "unary_op": lambda: tl.unary_op(r, g, abs),
        "write_only_unary_op": lambda: tl.write_only_unary_op(
            r, (2, 3), lambda i: i * 2),
        "binary_op": lambda: tl.binary_op(r, g, g, add),
        "ternary_op": lambda: tl.ternary_op(r, g, g, g,
                                            lambda x, y, z: x * y + z),
        "map": lambda: tl.map(r, add, g, g),
        "map_offset": lambda: tl.map_offset(r, lambda i, x: i + x, (6, 4),
                                            g),
        "map_reduce": lambda: tl.map_reduce(r, abs, None, 0.0, g),
        "map_then_reduce": lambda: tl.map_then_reduce(r, abs, g),
        "reduce": lambda: tl.reduce(r, g),
        "coalesced_reduction": lambda: tl.coalesced_reduction(r, g),
        "strided_reduction": lambda: tl.strided_reduction(r, g),
        "reduce_rows_by_key": lambda: tl.reduce_rows_by_key(r, g, keys, 3),
        "reduce_cols_by_key": lambda: tl.reduce_cols_by_key(r, g.T, keys, 3),
        "matrix_vector_op": lambda: tl.matrix_vector_op(r, g, g[0], add),
        "norm": lambda: tl.norm(r, g),
        "row_norm": lambda: tl.row_norm(r, g),
        "col_norm": lambda: tl.col_norm(r, g),
        "normalize": lambda: tl.normalize(r, g),
        "eig_dc": lambda: tl.eig_dc(r, sq),
        "eig_jacobi": lambda: tl.eig_jacobi(r, sq),
        "eig_sel": lambda: tl.eig_sel(r, sq, 2),
        "qr_get_q": lambda: tl.qr_get_q(r, g),
        "qr_get_qr": lambda: tl.qr_get_qr(r, g),
        "svd_qr": lambda: tl.svd_qr(r, g),
        "svd_eig": lambda: tl.svd_eig(r, g),
        "svd_jacobi": lambda: tl.svd_jacobi(r, g),
        "svd_reconstruction": lambda: tl.svd_reconstruction(
            r, g, g[0], sq),
        "rsvd_fixed_rank": lambda: tl.rsvd_fixed_rank(r, g, 2, p=1),
        "rsvd_perc": lambda: tl.rsvd_perc(r, g, 0.5, p=1),
        "lstsq_svd_qr": lambda: tl.lstsq_svd_qr(r, g, g[:, 0]),
        "lstsq_svd_jacobi": lambda: tl.lstsq_svd_jacobi(r, g, g[:, 0]),
        "lstsq_eig": lambda: tl.lstsq_eig(r, g, g[:, 0]),
        "lstsq_qr": lambda: tl.lstsq_qr(r, g, g[:, 0]),
        "cholesky_r1_update": lambda: tl.cholesky_r1_update(
            r, np.eye(3, dtype=np.float32), np.array([1, 2, 9], np.float32),
            3),
        "pca_fit": lambda: tl.pca_fit(r, g, 2),
        "pca_transform": lambda: tl.pca_transform(r, g, fit),
        "pca_inverse_transform": lambda: tl.pca_inverse_transform(
            r, g[:, :2], fit),
        "pca_fit_transform": lambda: tl.pca_fit_transform(r, g, 2),
        "pca_partial_fit": lambda: tl.pca_partial_fit(r, g, chunk_rows=4),
        "pca_finalize": lambda: tl.pca_finalize(r, state, 2),
        "tsvd_fit": lambda: tl.tsvd_fit(r, g, 2),
        "tsvd_transform": lambda: tl.tsvd_transform(r, g, tfit),
        "tsvd_inverse_transform": lambda: tl.tsvd_inverse_transform(
            r, g[:, :2], tfit),
        "tsvd_fit_transform": lambda: tl.tsvd_fit_transform(r, g, 2),
        "cal_eig": lambda: tl.cal_eig(r, sq, 2),
        "sign_flip_components": lambda: tl.sign_flip_components(arr(r, g)),
        "make_kvp": lambda: kvp.make_kvp(arr(r, keys), arr(r, g[:, 0])),
    }[entry]()


@pytest.mark.parametrize("entry", ["pairwise_distance", "fused_l2_nn_argmin",
                                   "knn", "select_k", "radix_select_k",
                                   "insert_select", "knn_fused",
                                   "insert_drain_ref", "spmv", "spmm",
                                   "csr_from_scipy", "csr_from_numpy",
                                   "from_numpy", "eigsh", "partition",
                                   "mst"] + LINALG_ENTRIES)
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
    from raft_tpu_torch.sparse.solver import eigsh, mst
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
            "from_numpy": lambda r: interop.from_numpy(a, res=r),
            "eigsh": lambda r: eigsh(ring.toarray(), k=2, res=r),
            "partition": lambda r: partition(r, ring, 2),
            "mst": lambda r: mst(r, ring).weights}.get(
                entry, lambda r: _linalg_call(entry, r, arr))
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


def test_from_numpy_keeps_bf16_bits_and_an_explicit_device():
    """An explicit device wins over the handle's; bf16 arrays arrive bit
    for bit, tuples stay tuples."""
    import numpy as np

    from raft_tpu_torch import interop

    import ml_dtypes

    bits = np.array([0x3F80, 0x7FC1, 0x0001, 0xFF80], np.uint16).view(
        np.int16)
    src = bits.view(ml_dtypes.bfloat16)
    got = interop.from_numpy(src, device="cpu")
    assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
    assert torch.equal(got.view(torch.int16), torch.from_numpy(bits))
    pair = interop.from_numpy((np.ones(3, np.float32), src), device="cpu")
    assert isinstance(pair, tuple) and pair[0].dtype == torch.float32


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
