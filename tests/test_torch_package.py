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
            "raft_tpu_torch.distance, raft_tpu_torch.interop; "
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

    kernels.reset_launch_counts()
    x = torch.randn(20, 5, generator=torch.Generator().manual_seed(0))
    tc.fused_lloyd_pallas(x, x[:3])
    tc.fused_l2_argmin_pallas(x, x[:3])
    tc.pairwise_l2_pallas(x, x[:3])
    assert set(kernels.launch_counts().values()) == {0}


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
