"""Nothing the benchmark runs loads JAX or the JAX package; the
references load nothing of the program either."""

import subprocess
import sys

import pytest

from portbench import harness, imports

SOURCES = sorted(p for p in harness.BENCH_DIR.rglob("*.py")
                 if "tests" not in p.relative_to(harness.BENCH_DIR).parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(harness.ROOT).as_posix())
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imports.source_imports(path) & set(imports.FORBIDDEN)


def test_the_references_import_nothing_of_the_program():
    for path in (harness.BENCH_DIR / "reference").rglob("*.py"):
        names = imports.source_imports(path)
        assert imports.PROGRAM not in names, path
        text = path.read_text()
        assert "portbench.drivers" not in text and "raft_tpu" not in text


def test_names_are_compared_whole():
    assert imports.loaded_forbidden(["raft_tpu_torch", "raft_tpu_torch.x",
                                     "jaxtyping", "flaxen"]) == []
    assert imports.loaded_forbidden(["raft_tpu.neighbors", "jax.numpy",
                                     "jaxlib"]) == ["jax", "jaxlib",
                                                    "raft_tpu"]


def test_loading_every_module_of_a_run_loads_no_jax():
    """In a fresh process: the command's modules, every driver and every
    metric reader, and the program they call."""
    code = (
        "import sys, portbench.run, portbench.calibrate\n"
        "from portbench import harness, imports\n"
        "bench = harness.load_json(harness.ROOT / 'BENCHMARK.json')\n"
        "for w in bench['workloads']:\n"
        "    c, _ = harness.find_cell(bench, w['name'], 1, 'cpu')\n"
        "    harness.load_driver(c.workload['driver'])\n"
        "for m in bench['per_layer']:\n"
        "    harness.load_reader(m['name'])\n"
        "import raft_tpu_torch.neighbors\n"
        "import raft_tpu_torch.cluster.kmeans\n"
        "print(imports.loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
