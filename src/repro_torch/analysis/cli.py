"""The port's ``reprolint`` CLI (port of ``repro/analysis/cli.py``):

    python -m repro_torch.analysis.cli --check --out results/reprolint_torch.json

The repo root is resolved from this file's location (as
``scripts/reprolint.py`` does for the reference), so the gate analyses
the same tree from any working directory.

Exit codes under ``--check``: 0 when the run is clean modulo the
checked-in baseline (no active findings, no stale baseline entries),
1 otherwise.  Without ``--check`` it always exits 0 and just reports —
the mode for exploring a new rule before wiring it into CI.

The JSON report (``--out``) carries rule counts, baseline size and wall
time, so the gate's cost and the baseline's shrink are both trackable.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis import engine
from repro_torch.analysis import rules as rules_mod

#: the checkout this module lives in: src/repro_torch/analysis/cli.py
REPO = Path(__file__).resolve().parents[3]


def _write_report(path: Path, report: engine.Report) -> None:
    from repro_torch.core.store import atomic_write_text

    atomic_write_text(str(path), json.dumps(report.as_dict(), indent=1,
                                            default=str))


def main(argv: Optional[List[str]] = None,
         repo_root: Optional[Path] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="reprolint",
        description="repo-contract static analyzer for src/repro_torch "
                    "(docs/ANALYSIS.md)")
    ap.add_argument("--root", default=None,
                    help=f"analysis root (default: "
                         f"<repo>/{engine.DEFAULT_ROOT})")
    ap.add_argument("--docs", default=None,
                    help="contract-docs dir (default: <repo>/docs)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: "
                         f"<repo>/{baseline_mod.DEFAULT_BASELINE})")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids (default: all)")
    ap.add_argument("--out", default=None,
                    help="write the JSON report here "
                         "(e.g. results/reprolint_torch.json)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on any non-baselined finding or any "
                         "stale baseline entry")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, r in rules_mod.RULES.items():
            print(f"{rid:18s} {r.summary}")
        return 0

    repo = Path(repo_root) if repo_root is not None else REPO
    rule_ids = ([s.strip() for s in args.rules.split(",") if s.strip()]
                if args.rules else None)
    report = engine.analyze(
        repo,
        src_root=Path(args.root) if args.root else None,
        docs_dir=Path(args.docs) if args.docs else None,
        baseline_path=Path(args.baseline) if args.baseline else None,
        rule_ids=rule_ids,
    )

    for f in report.findings:
        print(f.render())
    for e in report.stale_baseline:
        print(f"{e['file']}:{e['line']}: [baseline] stale entry for rule "
              f"'{e['rule']}' — the finding no longer fires there; "
              "delete the entry (the baseline only shrinks)")
    counts = report.rule_counts()
    summary = ", ".join(
        f"{rid}={c['findings']}" for rid, c in counts.items())
    print(f"reprolint: {len(report.findings)} finding(s) "
          f"[{summary}] over {report.files_scanned} files in "
          f"{report.wall_s:.2f}s; baseline={report.baseline_size} "
          f"(stale={len(report.stale_baseline)}, "
          f"baselined={len(report.baselined)}, "
          f"inline-ignored={len(report.ignored)})")

    if args.out:
        _write_report(Path(args.out), report)
        print(f"reprolint: report written to {args.out}")

    if args.check and not report.clean:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
