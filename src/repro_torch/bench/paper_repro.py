"""Paper-reproduction benchmark: Tables VI + Fig. 4 (speedup + accuracy);
port of ``benchmarks/paper_repro.py``.

Generates a proxy for each of the five real workloads through ONE shared
:class:`repro_torch.core.EvalSession`, so the sweep reuses profiles
across workloads (``--no-share`` builds a fresh engine per workload).
Each workload is seeded with its own ``BASE_P``, the reference benchmark's.
Reports, per workload: proxy speedup (Table VI), mean + per-metric
signature accuracy (Fig. 4), tuning iterations/evals, engine traffic,
and the tuning trace.

Usage::

  PYTHONPATH=src python -m repro_torch.bench.paper_repro [flags]

Flags:
  --scale F      input-scale multiplier for the real workloads (default 0.5)
  --iters N      max tuning iterations per workload (default 40)
  --workload W   one workload name, or "all" (default)
  --no-share     fresh engine per workload
  --out PATH     JSON output path (default results/paper_repro.json)
  --store DIR    persistent ProxyStore directory (needs the shared session)
  --device D     cuda (the default) or cpu
  --substrate S  torch (the default, stock ATen) or hopper (the proxies'
                 sort, matrix and statistics nodes on the kernels)

Output: a per-workload tuning log and a summary table, and the JSON
document of the reference benchmark, key for key::

  {
    "workloads": [            # one record per workload, sweep order
      {"workload": str, "scale": float, "qualified": bool,
       "mean_accuracy": float, "per_metric_accuracy": {metric: acc},
       "real_wall_time_s": float, "proxy_wall_time_s": float,
       "speedup": float, "iterations": int, "evals": int,
       "tree_depth": int, "target_metrics": {...}, "proxy_metrics": {...},
       "proxy_json": str,     # the tuned ProxyBenchmark, replayable
       "trace": [...],        # per-iteration TuneTrace records
       "tuning_wall_s": float,
       "engine_stats": {hits, misses, compiles, ...}},  # this workload's
      ...                                               # cache traffic
    ],
    # beyond the reference's keys, each record's "real_timing" and
    # "proxy_timing": how each wall time was taken (Signature.timing)
    "session": {              # absent with --no-share
      "stats": {hits, misses, compiles, cross_workload_hits, ...},
      "per_workload": {name: stats-delta},
      "total_tuning_wall_s": float
    }
  }
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

from repro_torch.bench._io import write_json
from repro_torch.core import EvalSession, ProxyStore, generate_proxy
from repro_torch.core.motifs import PVector
from repro_torch.core.motifs.base import SUBSTRATES
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.workloads import WORKLOADS

# per-workload base P seeds (the paper scales down the original input to
# initialise dataSize; chunk/task counts follow the workload's layout)
BASE_P = {
    "terasort": PVector(data_size=1 << 14, chunk_size=1 << 10, num_tasks=8,
                        channels=24),
    "kmeans": PVector(data_size=1 << 14, chunk_size=64, num_tasks=8,
                      batch_size=32, distribution="normal", sparsity=0.9),
    "pagerank": PVector(data_size=1 << 14, chunk_size=1 << 10, num_tasks=8,
                        distribution="zipf"),
    "alexnet": PVector(data_size=1 << 11, chunk_size=256, num_tasks=2,
                       batch_size=8, height=24, width=24, channels=16,
                       distribution="normal"),
    "inception_v3": PVector(data_size=1 << 11, chunk_size=256, num_tasks=2,
                            batch_size=4, height=24, width=24, channels=16,
                            distribution="normal"),
}


#: the keys the document's parts hold, as the reference benchmark's docstring
#: names them: each workload record, its engine stats, the session block
#: and the session's stats
RECORD_KEYS = ("workload", "scale", "qualified", "mean_accuracy",
               "per_metric_accuracy", "real_wall_time_s",
               "proxy_wall_time_s", "speedup", "iterations", "evals",
               "tree_depth", "target_metrics", "proxy_metrics", "proxy_json",
               "trace", "tuning_wall_s", "engine_stats")
#: the port's own keys of each record: how the real step's and the
#: proxy's wall times were taken (``Signature.timing``)
EXTRA_RECORD_KEYS = ("real_timing", "proxy_timing")
ENGINE_KEYS = ("hits", "misses", "compiles")
SESSION_KEYS = ("stats", "per_workload", "total_tuning_wall_s")
SESSION_STATS_KEYS = ("hits", "misses", "compiles", "cross_workload_hits")


def missing_keys(doc: Dict[str, Any], shared: bool = True) -> List[str]:
    """The keys of the reference's document that ``doc`` lacks, as
    paths; empty when it has them all.  ``shared=False``: no session
    block is expected (``--no-share``)."""
    out = [f"workloads[{i}].{k}" for i, r in enumerate(doc["workloads"])
           for k in RECORD_KEYS if k not in r]
    out += [f"workloads[{i}].engine_stats.{k}"
            for i, r in enumerate(doc["workloads"])
            for k in ENGINE_KEYS if k not in r.get("engine_stats", {})]
    if shared:
        sess = doc.get("session", {})
        out += [f"session.{k}" for k in SESSION_KEYS if k not in sess]
        out += [f"session.stats.{k}" for k in SESSION_STATS_KEYS
                if k not in sess.get("stats", {})]
    return out


def run_one(name: str, scale: float, max_iters: int, seed: int = 0,
            session: Optional[EvalSession] = None,
            device: DeviceLike = None, substrate: Optional[str] = None):
    """``generate_proxy`` on workload ``name`` from its ``BASE_P``; prints
    the report and per-metric accuracy.  ``substrate`` ``None`` takes the
    session's, else ``"torch"``.  Returns (proxy, report, tuning wall
    seconds)."""
    w = WORKLOADS[name]
    args = w.inputs(seed, scale, device=device)
    t0 = time.time()
    pb, rep = generate_proxy(
        w.step, *args, name=name, hints=w.hints,
        base_p=BASE_P.get(name, PVector()), max_iters=max_iters, seed=seed,
        session=session, substrate=substrate, device=device)
    wall = time.time() - t0
    print(f"{rep.summary()}  (tuning wall {wall:.0f}s, "
          f"engine {rep.engine_stats})")
    for k in sorted(rep.per_metric_accuracy):
        print(f"    {k:22s} tgt={rep.target_metrics[k]:.4g} "
              f"proxy={rep.proxy_metrics[k]:.4g} "
              f"acc={rep.per_metric_accuracy[k]:.3f}")
    return pb, rep, wall


def record(name: str, scale: float, pb, rep, wall: float) -> Dict[str, Any]:
    """One workload's entry of the JSON document."""
    return {
        "workload": name,
        "scale": scale,
        "qualified": rep.qualified,
        "mean_accuracy": rep.mean_accuracy,
        "per_metric_accuracy": dict(rep.per_metric_accuracy),
        "real_wall_time_s": rep.real_wall_time,
        "proxy_wall_time_s": rep.proxy_wall_time,
        "speedup": rep.speedup,
        "iterations": rep.iterations,
        "evals": rep.evals,
        "tree_depth": rep.tree_depth,
        "target_metrics": dict(rep.target_metrics),
        "proxy_metrics": dict(rep.proxy_metrics),
        "proxy_json": pb.to_json(),
        "trace": [dataclasses.asdict(t) for t in rep.trace],
        "tuning_wall_s": wall,
        "engine_stats": dict(rep.engine_stats),
        "real_timing": dict(rep.real_timing),
        "proxy_timing": dict(rep.proxy_timing),
    }


def session_doc(session: EvalSession, total_wall: float) -> Dict[str, Any]:
    """The document's ``session`` block."""
    return {
        "stats": session.stats(),
        "per_workload": {k: dict(v)
                         for k, v in session.workload_stats.items()},
        "total_tuning_wall_s": total_wall,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scale", type=float, default=0.5)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--workload", default="all")
    ap.add_argument("--no-share", action="store_true",
                    help="per-workload engines (no shared EvalSession)")
    ap.add_argument("--out", default="results/paper_repro.json")
    ap.add_argument("--store", default=None,
                    help="persistent ProxyStore directory: warm-start "
                         "eval-form signatures across processes; needs "
                         "the shared session")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--substrate", default="torch", choices=SUBSTRATES,
                    help="hopper: the proxies' hot loops on the kernels")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    names = sorted(WORKLOADS) if args.workload == "all" else [args.workload]
    store = ProxyStore(args.store) if args.store else None
    session = None if args.no_share else EvalSession(
        run=True, seed=0, store=store, substrate=args.substrate, device=dev)
    records: List[Dict[str, Any]] = []
    t_sweep = time.time()
    for name in names:
        pb, rep, wall = run_one(name, args.scale, args.iters,
                                session=session, device=dev,
                                substrate=args.substrate)
        records.append(record(name, args.scale, pb, rep, wall))
    total_wall = time.time() - t_sweep

    doc: Dict[str, Any] = {"workloads": records}
    if session is not None:
        doc["session"] = session_doc(session, total_wall)

    write_json(args.out, doc)

    print("\n=== paper reproduction summary (Table VI / Fig. 4 analog) ===")
    print(f"{'workload':14s} {'qualified':>9s} {'mean_acc':>9s} "
          f"{'speedup':>8s} {'real_s':>10s} {'proxy_s':>10s} {'iters':>6s} "
          f"{'compiles':>9s}  timing (real/proxy)")
    for r in records:
        sp = f"{r['speedup']:.2f}x" if r["speedup"] else "n/a"
        print(f"{r['workload']:14s} {str(r['qualified']):>9s} "
              f"{r['mean_accuracy']:9.1%} {sp:>8s} "
              f"{r['real_wall_time_s']:10.6f} {r['proxy_wall_time_s']:10.6f} "
              f"{r['iterations']:6d} "
              f"{r['engine_stats'].get('compiles', 0):9d}  "
              f"{r['real_timing'].get('mode')}/"
              f"{r['proxy_timing'].get('mode')}")
    if session is not None:
        st = session.stats()
        print(f"\nshared session: {st['compiles']} compiles for "
              f"{st['evals']} evals, {st['hits']} cache hits "
              f"({st['cross_workload_hits']} cross-workload)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
