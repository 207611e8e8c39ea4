"""One run of one cell: find its files by name, set up, measure the
window, judge the output against the reference, and build the result.

:func:`run` is what ``python3 -m portbench.run`` calls. Tests call it
with ``require_card=False`` on the CPU at small sizes (the program runs
its kernels' plain versions there); the command line never does.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from portbench import compare, imports, trace
from portbench.drivers import Cell, WindowResult

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


class NoCard(RuntimeError):
    """The run found fewer CUDA cards than the cell asks for."""


class ForbiddenImport(RuntimeError):
    """JAX or the JAX package is loaded in the run's process."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def find_cell(bench: dict, name: str, seed: int, device,
              bench_dir: Path = BENCH_DIR):
    """``(Cell, its BENCHMARK.json entry)`` from the files alone."""
    entry = _named(bench["workloads"], name, "workload")
    config_entry = _named(bench["configs"], entry["config"], "config")
    config = load_json(bench_dir.parent / config_entry["file"])
    mix = load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    workload = load_json(bench_dir / "workloads" / f"{name}.json")
    return Cell(name, config, mix, workload, int(seed),
                torch.device(device)), entry


def load_driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}").Driver


def load_reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def end_to_end_for(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer_for(bench: dict, cell: str) -> List[dict]:
    mine = {m["name"] for m in end_to_end_for(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


@dataclasses.dataclass
class Reading:
    """What a per-layer reader sees of a traced run."""

    cell: str
    window: WindowResult
    trace: trace.TraceSummary
    counts: Dict[str, float]


@dataclasses.dataclass
class Outcome:
    result: dict
    evidence: List[str]
    checks: compare.Checks
    check_s: float


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip().splitlines()
        return out[0] if out else None
    except (OSError, subprocess.SubprocessError):
        return None


class GcPauses:
    """The garbage collector's pauses while the body runs (seconds, in
    all and the longest), from ``gc.callbacks``."""

    def __init__(self):
        self.total = 0.0
        self.longest = 0.0
        self._t0 = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            dt = time.perf_counter() - self._t0
            self.total += dt
            self.longest = max(self.longest, dt)
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


def _plain(v: float):
    """A number for the JSON line: "inf" or "nan" as text."""
    return v if math.isfinite(v) else str(v)


def _launch_counts() -> Dict[str, int]:
    from raft_tpu_torch import kernels

    return dict(kernels.launch_counts())


def run(cell_name: str, seed: int, seconds: float, traced: bool, *,
        t_start: float, require_card: bool = True, device: str = "cuda:0",
        tier: Optional[str] = None, bench: Optional[dict] = None,
        bench_dir: Path = BENCH_DIR, overrides: Optional[dict] = None
        ) -> Outcome:
    """One run. ``tier`` replaces the configuration's precision tier
    (the control); ``overrides`` replace keys of the configuration, the
    mix or the workload file (tests only)."""
    found = imports.loaded_forbidden()
    if found:
        raise ForbiddenImport(f"loaded at start: {found}")
    if bench is None:
        bench = load_json(bench_dir.parent / "BENCHMARK.json")
    cell, entry = find_cell(bench, cell_name, seed, device, bench_dir)
    if require_card:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < int(entry["chips"]):
            raise NoCard(f"{cell_name} needs {entry['chips']} CUDA card(s); "
                         f"found {torch.cuda.device_count()}")
        if cell.device.type != "cuda":
            raise NoCard("the benchmark runs on a CUDA card only")
    for part, extra in (overrides or {}).items():
        getattr(cell, part).update(extra)
    from raft_tpu_torch.util import precision

    precision.set_matmul_precision(tier or cell.config["precision"])
    driver = load_driver(cell.workload["driver"])(cell)
    driver.setup()
    driver.sync()
    # what set-up left behind is never traversed by the collector in the
    # window: its pauses are then the window's own objects'
    gc.collect()
    gc.freeze()
    setup_s = time.monotonic() - t_start

    on_card = cell.device.type == "cuda"
    before = _launch_counts()
    summary = None
    pauses = GcPauses()
    if traced:
        with trace.profiled() as holder, pauses:
            with trace.span(trace.WINDOW):
                win = driver.window(seconds, trace.span)
        summary = holder.summary
    else:
        with pauses:
            win = driver.window(seconds, trace.span)
    driver.result = win
    after = _launch_counts()
    launches = {k: after[k] - before.get(k, 0) for k in after
                if after[k] != before.get(k, 0)}
    peak = torch.cuda.max_memory_allocated(cell.device) if on_card else 0

    metrics: Dict[str, dict] = {}
    if traced:
        reading = Reading(cell_name, win, summary, driver.layer_counts())
        for m in per_layer_for(bench, cell_name):
            value = load_reader(m["name"], bench_dir)(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in end_to_end_for(bench, cell_name):
            value = setup_s if m["name"] == "setup_s" \
                else win.end_to_end[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t_check = time.monotonic()
    driver.release()
    gc.collect()
    try:
        numbers = driver.check()
        checks = compare.held(numbers, cell.workload["limits"])
        correct = compare.all_within(checks)
    except Exception as exc:  # noqa: BLE001 — a check that cannot run fails
        checks = {"check_raised": (math.inf, 0.0)}
        correct = False
        win.evidence["check_error"] = f"{type(exc).__name__}: {exc}"
    check_s = time.monotonic() - t_check
    found = imports.loaded_forbidden()
    if found:
        raise ForbiddenImport(f"loaded after the window: {found}")

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(cell.device) if on_card
           else "cpu",
           "count": int(entry["chips"]),
           "memory_peak_bytes": int(peak)}
    if on_card:
        dev["power_limit"] = _power_limit()
    result = {"correct": bool(correct), "attempted": int(win.attempted),
              "failed": int(win.failed), "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.top_ops(),
                               "idle_gaps": summary.idle_gaps()}
    result["checks"] = {name: {"value": _plain(v), "limit": lim}
                        for name, (v, lim) in checks.items()}
    evidence = [f"evidence window_s {win.seconds!r}",
                f"evidence setup_s {setup_s!r}",
                f"evidence launches {json.dumps(launches, sort_keys=True)}",
                f"evidence memory_peak_bytes {peak}",
                f"evidence check_s {check_s!r}",
                f"evidence counts {json.dumps(win.counts, sort_keys=True)}",
                f"evidence gc_pauses_s_total_max "
                f"{json.dumps([pauses.total, pauses.longest])}"]
    evidence += [f"evidence {k} {json.dumps(v)}"
                 for k, v in win.evidence.items()]
    return Outcome(result, evidence, checks, check_s)
