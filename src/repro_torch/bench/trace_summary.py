"""Per-stage wall breakdown + top-N slowest spans from a trace file (the
port's own copy of ``scripts/trace_summary.py``).

Reads a Chrome trace-event JSON exported by
``repro_torch.runtime.telemetry.Telemetry.export_trace`` (the
``docs/OBSERVABILITY.md`` export contract — also loadable in Perfetto)
and prints the numbers a human wants first: where the wall time went
per span kind, and which individual spans were slowest.

``--check`` turns the script into a gate (``chip_smoke.py`` runs it on
the trace of ``repro_torch.bench.serve_bench --trace``) that exits
nonzero when

1. the file is unloadable, not a trace document, or holds no spans;
2. any ``--require``d span kind is missing (default: the serving
   request decomposition + the compile path);
3. any ``serve.request`` span's queue-wait/batch-assembly/service
   children do not sum to the parent's duration within ``--sum-tol``
   seconds — the accounting invariant that makes the breakdown
   trustworthy.

Usage:  PYTHONPATH=src python -m repro_torch.bench.trace_summary trace.json
            [--top 10]
            [--check] [--require serve.request,eval.compile,...]
            [--sum-tol 0.002] [--out results/trace_summary.json]
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

#: span kinds a traced serve_bench run must contain (docs/OBSERVABILITY.md;
#: eval.execute is absent by design — serve_bench tunes on compile-time
#: metrics, run=False — so it is not required here)
DEFAULT_REQUIRED = ("serve.request", "serve.queue_wait",
                    "serve.batch_assembly", "serve.service", "serve.batch",
                    "eval.batch", "eval.compile")


def load_trace(path: str) -> List[Dict[str, Any]]:
    """The complete-span ('X') and instant ('i') events of a trace file;
    raises ValueError on anything that is not a loadable trace."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        raise ValueError(f"unreadable trace file: {e}") from e
    except json.JSONDecodeError as e:
        raise ValueError(f"trace is not valid JSON: {e}") from e
    events = doc.get("traceEvents") if isinstance(doc, dict) else None
    if not isinstance(events, list):
        raise ValueError("not a trace document: no traceEvents list")
    return [e for e in events if e.get("ph") in ("X", "i")]


def summarize(events: List[Dict[str, Any]], top: int = 10) -> Dict[str, Any]:
    """Aggregate: per-name {count, wall_s, mean_s, max_s, share} over
    complete spans, instant counts, and the ``top`` slowest spans."""
    per: Dict[str, Dict[str, float]] = {}
    instants: Dict[str, int] = {}
    spans: List[Dict[str, Any]] = []
    for e in events:
        name = e.get("name", "?")
        if e["ph"] == "i":
            instants[name] = instants.get(name, 0) + 1
            continue
        dur_s = float(e.get("dur", 0.0)) / 1e6
        agg = per.setdefault(name, {"count": 0, "wall_s": 0.0, "max_s": 0.0})
        agg["count"] += 1
        agg["wall_s"] += dur_s
        agg["max_s"] = max(agg["max_s"], dur_s)
        spans.append(e)
    # share of the per-kind total, NOT of elapsed time: spans nest and
    # overlap across threads, so kind sums legitimately exceed wall clock
    total = sum(a["wall_s"] for a in per.values()) or 1.0
    for a in per.values():
        a["mean_s"] = a["wall_s"] / a["count"]
        a["share"] = a["wall_s"] / total
    spans.sort(key=lambda e: -float(e.get("dur", 0.0)))
    slowest = [{"name": e.get("name"), "dur_s": float(e["dur"]) / 1e6,
                "ts_s": float(e.get("ts", 0.0)) / 1e6,
                "args": e.get("args", {})}
               for e in spans[:top]]
    return {"spans": dict(sorted(per.items(),
                                 key=lambda kv: -kv[1]["wall_s"])),
            "instants": instants, "slowest": slowest,
            "span_events": len(spans)}


def check_request_sums(events: List[Dict[str, Any]],
                       tol_s: float) -> List[str]:
    """The serve.request accounting invariant: each request span's
    queue_wait + batch_assembly + service children sum to the parent's
    duration within ``tol_s`` seconds.  Returns failure strings."""
    by_parent: Dict[int, float] = {}
    requests: Dict[int, float] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        args = e.get("args", {})
        if e.get("name") == "serve.request":
            requests[args.get("id")] = float(e.get("dur", 0.0)) / 1e6
        elif e.get("name") in ("serve.queue_wait", "serve.batch_assembly",
                               "serve.service"):
            pid = args.get("parent")
            if pid is not None:
                by_parent[pid] = (by_parent.get(pid, 0.0)
                                  + float(e.get("dur", 0.0)) / 1e6)
    failures = []
    for rid, dur in requests.items():
        child_sum = by_parent.get(rid)
        if child_sum is None:
            failures.append(f"serve.request id={rid} has no "
                            f"queue/assembly/service children")
        elif abs(child_sum - dur) > tol_s:
            failures.append(f"serve.request id={rid}: children sum "
                            f"{child_sum:.6f}s != span {dur:.6f}s "
                            f"(tol {tol_s}s)")
    return failures


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="Chrome trace JSON from export_trace / "
                                  "a bench's --trace flag")
    ap.add_argument("--top", type=int, default=10,
                    help="how many slowest spans to print")
    ap.add_argument("--check", action="store_true",
                    help="gate: unloadable/empty trace, missing required "
                         "span kinds, or broken request child-sum "
                         "accounting exit nonzero")
    ap.add_argument("--require", default=",".join(DEFAULT_REQUIRED),
                    help="comma list of span kinds that must be present "
                         "under --check (empty string disables)")
    ap.add_argument("--sum-tol", type=float, default=0.002,
                    help="absolute tolerance (seconds) for the "
                         "serve.request child-sum check")
    ap.add_argument("--out", default=None,
                    help="also write the summary as JSON")
    args = ap.parse_args(argv)

    try:
        events = load_trace(args.trace)
    except ValueError as e:
        print(f"CHECK FAIL: {e}" if args.check else f"error: {e}",
              file=sys.stderr)
        return 1

    summary = summarize(events, top=args.top)
    failures: List[str] = []
    if args.check:
        if summary["span_events"] == 0:
            failures.append("trace holds no complete spans")
        required = [r for r in args.require.split(",") if r]
        missing = [r for r in required if r not in summary["spans"]]
        if missing:
            failures.append(f"required span kinds missing: "
                            f"{', '.join(missing)}")
        failures.extend(check_request_sums(events, args.sum_tol))
    summary["check"] = {"checked": bool(args.check), "failures": failures}

    print(f"trace: {args.trace} — {summary['span_events']} spans, "
          f"{sum(summary['instants'].values())} instants")
    print(f"{'span kind':<24}{'count':>7}{'wall_s':>10}{'mean_s':>10}"
          f"{'max_s':>10}{'share':>8}")
    for name, a in summary["spans"].items():
        print(f"{name:<24}{a['count']:>7}{a['wall_s']:>10.4f}"
              f"{a['mean_s']:>10.5f}{a['max_s']:>10.4f}{a['share']:>8.1%}")
    for name, n in sorted(summary["instants"].items()):
        print(f"{name:<24}{n:>7}  (instant)")
    print(f"top {min(args.top, len(summary['slowest']))} slowest spans:")
    for s in summary["slowest"]:
        print(f"  {s['dur_s']:>10.4f}s  {s['name']}  {s['args']}")

    if args.out:
        from repro_torch.bench._io import write_json

        write_json(args.out, summary)
    for f in failures:
        print(f"CHECK FAIL: {f}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
