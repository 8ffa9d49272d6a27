"""Roofline table (port of ``benchmarks/roofline.py``): reads a dry-run
sweep's records (``repro_torch.launch.dryrun --out``) and prints, per
(arch x shape x mesh): the three roofline terms, the dominant bottleneck,
MODEL_FLOPS/profiled flops, and a one-line fix note.  The terms are on
``launch.mesh.HW``, the H100 SXM5 data sheet (700 W); the collective
term at NVLink's rate is a lower bound on a 256-GPU mesh, which crosses
nodes.

Usage:  PYTHONPATH=src python -m repro_torch.bench.roofline \\
            [--json results/dryrun_all.json] [--mesh 16x16] [--md out.md]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

FIX_NOTES = {
    "compute_s": "more chips / lower-precision matmuls; compute-bound is "
                 "the healthy end state",
    "memory_s": "cut HBM traffic: fuse, remat less aggressively, shrink "
                "collect-materialised buffers (MoE dispatch), bf16 "
                "accumulators",
    "collective_s": "reshard to cut all-gathers (2D sharding), overlap "
                    "collectives with compute, gradient compression",
}


def load(path: str) -> List[Dict]:
    with open(path) as f:
        return json.load(f)


def fmt_row(r: Dict) -> str:
    if r.get("skipped"):
        return (f"| {r['arch']} | {r['shape']} | - | skipped | "
                f"{r['skipped'][:60]} | | | |")
    useful = r.get("useful_flops_fraction", 0.0)
    return ("| {arch} | {shape} | {mesh} | {c:.3f} | {m:.3f} | {x:.3f} | "
            "{dom} | {useful:.2f} | {fits} |").format(
        arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
        c=r["compute_s"], m=r["memory_s"], x=r["collective_s"],
        dom=r["dominant"].replace("_s", ""), useful=useful,
        fits="y" if r.get("fits_hbm") else "N")


def table(records: List[Dict], mesh: str = "16x16") -> str:
    """The table and its summary lines for the records on ``mesh`` (and
    every skipped cell)."""
    rows = [r for r in records
            if r.get("skipped") or r.get("mesh") == mesh]

    header = ("| arch | shape | mesh | compute_s | memory_s | collective_s "
              "| dominant | useful_flops | fits_hbm |")
    sep = "|" + "---|" * 9
    lines = [header, sep] + [fmt_row(r) for r in rows]

    # summary: worst cells by each criterion
    live = [r for r in rows if not r.get("skipped") and "dominant" in r]
    if live:
        worst_useful = min(live, key=lambda r: r.get("useful_flops_fraction",
                                                     1.0))
        most_coll = max(live, key=lambda r: r.get("collective_s", 0.0))
        lines += [
            "",
            f"worst useful-flops cell: {worst_useful['arch']} x "
            f"{worst_useful['shape']} "
            f"({worst_useful['useful_flops_fraction']:.3f})",
            f"most collective-bound cell: {most_coll['arch']} x "
            f"{most_coll['shape']} ({most_coll['collective_s']:.3f}s)",
        ]
        doms = {}
        for r in live:
            doms[r["dominant"]] = doms.get(r["dominant"], 0) + 1
        lines.append(f"dominant-term histogram: {doms}")
        lines.append("fix notes: " + json.dumps(FIX_NOTES, indent=1))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--json", default="results/dryrun_all.json")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--md", default=None)
    args = ap.parse_args(argv)

    if not os.path.exists(args.json):
        print(f"[roofline] {args.json} missing — run the dry-run sweep first",
              file=sys.stderr)
        return 1
    text = table(load(args.json), args.mesh)
    print(text)
    if args.md:
        from repro_torch.core.store import atomic_write_text

        atomic_write_text(args.md, text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
