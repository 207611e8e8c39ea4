"""Readings the limits are set from, on the card, in one process::

    python3 -m portbench.calibrate --workload sift1m-flat.batch \\
        --seeds 1,2,3 [--control-seeds 4,5,6] [--fault unchanged:7,8,9] \\
        [--seconds 3]

Each seed is a whole run of the cell (set-up, a short window at the
cell's own load, the comparison): ``--seeds`` as the configuration
states, ``--control-seeds`` at the program's next tier down
('default', one bf16 pass, below the configurations' 'high'),
``--fault name:seeds`` with a fault of ``portbench.faults`` planted.
One JSON line a run, with every compared number.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from portbench import faults, harness


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell, _ = harness.find_cell(bench, args.workload, 0, "cuda:0")
    runs = [("sound", None, None, s) for s in _seeds(args.seeds)]
    runs += [("control", "default", None, s)
             for s in _seeds(args.control_seeds)]
    for spec in args.fault:
        name, seeds = spec.split(":")
        runs += [(f"fault:{name}", None, name, s) for s in _seeds(seeds)]
    for kind, tier, fault, seed in runs:
        undo = faults.plant(harness.load_driver(cell.workload["driver"]),
                            fault) if fault else None
        try:
            out = harness.run(args.workload, seed, args.seconds, False,
                              t_start=time.monotonic(), tier=tier,
                              bench=bench)
        finally:
            if undo:
                undo()
        print(json.dumps({"kind": kind, "seed": seed,
                          "correct": out.result["correct"],
                          "numbers": {k: v for k, (v, _) in
                                      out.checks.items()},
                          "metrics": out.result["metrics"],
                          "check_s": out.check_s}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
