"""Run one cell of ``BENCHMARK.json`` on this machine's CUDA card(s)::

    python3 -m portbench.run --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result; the lines before the last on standard error are the run's
evidence and then each compared number beside its limit. Exits 2
(no result) without enough CUDA cards, 3 if JAX or the JAX package is
loaded.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed
    paths, so only a cell's first run there compiles."""
    build = ROOT / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _caches()

    import torch

    from portbench import harness

    torch.set_num_threads(4)
    try:
        out = harness.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start=T_START)
    except harness.NoCard as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 2
    except harness.ForbiddenImport as exc:
        print(f"no result: JAX or the JAX package is loaded ({exc})",
              file=sys.stderr)
        return 3
    for line in out.evidence:
        print(line, file=sys.stderr)
    for name, (value, limit) in out.checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out.result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
