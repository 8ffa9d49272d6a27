"""The spread of ``scenario_matrix --check``'s population gate.

The gate asks the sharded population bench to beat one rank
(``speedup > 1``).  Its speedup is a ratio of two walls, so it moves
with whatever else the host runs.  This script runs the CPU test's quick
check (``tests/test_torch_scenario_matrix.py``: ``--quick`` in two gloo
ranks, ``--pop`` candidates) ``--runs`` times alone, then ``--runs``
times beside ``--busy`` CPU-bound processes (the load of a test run's
other workers), and reports each run's single and sharded walls and
speedup, and the median and minimum speedup of each series.

Usage::

  PYTHONPATH=src python tests/torch_gate_spread.py --runs 10 --busy 5 \\
      [--out results/gate_spread.json]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Any, Dict, List

SRC = Path(__file__).resolve().parents[1] / "src"

#: a process that keeps one core busy until it is killed
SPIN = "while True:\n    pass\n"
#: seconds one run's ranks may take
TIMEOUT = 240


def one_run(pop: int, ranks: int) -> Dict[str, Any]:
    """One ``scenario_matrix --quick --check`` run: its exit code and
    its population bench's walls and speedup."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "sm.json"
        env = dict(os.environ, PYTHONPATH=str(SRC),
                   REPRO_EMU_DEVICES=str(ranks))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.bench.scenario_matrix",
             "--quick", "--device", "cpu", "--scenarios", "single,dp2",
             "--pop", str(pop), "--check", "--out", str(out),
             "--timeout", str(TIMEOUT)],
            env=env, capture_output=True, text=True, timeout=TIMEOUT + 60)
        doc = json.loads(out.read_text()) if out.exists() else {}
    pb = doc.get("population_bench") or {}
    return {"rc": proc.returncode,
            "single_wall_s": pb.get("single_wall_s"),
            "sharded_wall_s": pb.get("sharded_wall_s"),
            "speedup": pb.get("speedup")}


def series(runs: int, busy: int, pop: int, ranks: int) -> Dict[str, Any]:
    """``runs`` runs, each beside ``busy`` spinning processes."""
    spinners = [subprocess.Popen([sys.executable, "-c", SPIN])
                for _ in range(busy)]
    try:
        recs: List[Dict[str, Any]] = []
        for i in range(runs):
            rec = one_run(pop, ranks)
            recs.append(rec)
            print(f"[gate_spread] busy={busy} run {i}: rc={rec['rc']} "
                  f"single={rec['single_wall_s']} "
                  f"sharded={rec['sharded_wall_s']} "
                  f"speedup={rec['speedup']}", flush=True)
    finally:
        for p in spinners:
            p.kill()
            p.wait()
    sp = [r["speedup"] for r in recs if r["speedup"] is not None]
    return {"busy": busy, "runs": recs,
            "median_speedup": statistics.median(sp) if sp else None,
            "min_speedup": min(sp) if sp else None,
            "failed_runs": sum(1 for r in recs if r["rc"] != 0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--busy", type=int, default=5,
                    help="CPU-bound processes beside the loaded series")
    ap.add_argument("--pop", type=int, default=4)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    doc: Dict[str, Any] = {"pop": args.pop, "ranks": args.ranks,
                           "cpus": os.cpu_count(),
                           "alone": series(args.runs, 0, args.pop,
                                           args.ranks),
                           "loaded": series(args.runs, args.busy, args.pop,
                                            args.ranks)}
    summary = {k: {"median": v["median_speedup"], "min": v["min_speedup"],
                   "failed_runs": v["failed_runs"]}
               for k, v in doc.items() if isinstance(v, dict)}
    print(json.dumps({"gate_spread": summary, "pop": args.pop}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(doc, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
