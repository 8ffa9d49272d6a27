"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload kmeans.proxy --seed 7 \
        --seconds 10 --trace 0

Run from the root of a checkout on a machine with the cell's CUDA cards.
Prints the run's result as the last line of standard output (one JSON
object) and, as the last lines of standard error, each number the check
compared beside its limit.  Exits non-zero, printing no result, when
there is no card (or too few), when the checkout holds no program, or
when the process has loaded the JAX stack or the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: build and kernel caches of the program, at fixed paths in the checkout
#: (the port's own kernels build into src/repro_torch/kernels/_build/)
CACHE = ROOT / ".portbench_cache"
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton",
              "CUDA_CACHE_PATH": "cuda"}


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read ({exc})"
    return out.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell")
    ap.add_argument("--workload", required=True, help="the cell's name")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), this machine has {have}", file=sys.stderr)
        return 2
    try:
        harness.import_program()
    except harness.ProgramMissing as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_START)
    checks = result.pop("checks")
    result["card"] = card()
    result["checks"] = checks  # the compared numbers come last
    print(f"portbench: {result['card']}", file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the process holds forbidden modules: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
