"""Medians and spreads of the runs ``sets.sh`` left under a directory.

    python3 portbench/tools/spread.py <out>/<tag>

For each cell and set: each end-to-end metric's median and its spread,
the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) over the median; the first run of
a set is listed apart for ``setup_s``.  For the traced runs: each
per-layer metric's values, the memory peak and the busy share.  Then,
for each metric, the widest spread over the cells and five times it.
"""
from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict
from pathlib import Path


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(where: str) -> int:
    runs = defaultdict(list)
    for f in sorted(Path(where).glob("*.out"),
                    key=lambda f: (f.name.rsplit(".", 3)[0],
                                   f.name.rsplit(".", 3)[1],
                                   int(f.name.rsplit(".", 3)[2]))):
        cell, set_, seed, _ = f.name.rsplit(".", 3)
        lines = f.read_text().strip().splitlines()
        if not lines:
            print(f"{f.name}: no result")
            continue
        runs[cell, set_].append((int(seed), json.loads(lines[-1])))
    widest = defaultdict(float)
    for (cell, set_), rs in sorted(runs.items()):
        bad = [s for s, r in rs if not r["correct"]]
        peak = max(r["device"]["memory_peak_bytes"] for _, r in rs)
        print(f"{cell} {set_}: {len(rs)} runs, not correct {bad}, "
              f"peak {peak} B")
        if set_ == "T":
            for name in rs[0][1]["metrics"]:
                vals = [r["metrics"][name]["value"] for _, r in rs]
                print(f"  {name}: {vals}")
            print("  busy/window: " + ", ".join(
                f"{r['device']['busy_s']!r}/{r['device']['window_s']!r}"
                for _, r in rs))
            continue
        for name in rs[0][1]["metrics"]:
            vals = [r["metrics"][name]["value"] for _, r in rs]
            if name == "setup_s":
                print(f"  setup_s first {vals[0]!r}, then median "
                      f"{statistics.median(vals[1:])!r}")
                vals = vals[1:]
            sp = spread(vals) if len(vals) > 2 else float("nan")
            if name != "setup_s":
                widest[name] = max(widest[name], sp)
            print(f"  {name}: median {statistics.median(vals)!r} spread "
                  f"{sp:.5f} values {vals}")
    for name, sp in widest.items():
        print(f"widest {name}: {sp:.5f}, five times {5 * sp:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
