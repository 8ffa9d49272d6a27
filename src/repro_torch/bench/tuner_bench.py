"""Serial vs batched vs session-shared candidate evaluation for the tuner;
port of ``benchmarks/tuner_bench.py``.

Three modes.

**Single** (the default) builds the candidate batch the decision-tree
tuner's impact-analysis stage submits (base + one-at-a-time perturbations
of every movable P entry, plus data-characteristic variants) and
evaluates it for several tuning iterations two ways:

* **serial**: one eval-form profile (+ wall) per candidate, every
  iteration, nothing shared (:func:`serial_evaluate_batch`, whose
  profiles the engine's must equal, so metric parity is exact);
* **batched**: through :class:`repro_torch.core.BatchEvaluator`:
  candidates deduped by shape signature, each class profiled once and
  served from the LRU cache on every later iteration.

It also runs the vmapped population path (one population form per
weight-free shape class, the whole class in one call) and the
mesh-divisibility ("qualification") profile of the batch: the fraction of
raw candidates already divisible by a 4-way batch quantum, and the same
after :func:`repro_torch.core.cluster.quantize_proxy` (always 1.0).

**Priors** (``--priors``): the same 3-motif chain (matrix -> sort ->
statistics) tuned to a shifted-mix target twice through one engine, cold
and seeded with :func:`repro_torch.core.priors.elasticity_priors`;
fails unless the prior-seeded run reaches tolerance in fewer evaluator
calls.

**Sweep** (``--sweep``): a five-workload mini-sweep of motif chains,
once with a fresh engine per workload and once through one shared
:class:`EvalSession`; fails unless the metrics agree exactly, the shared
session profiles fewer classes and it has a nonzero cross-workload hit
count.

Usage::

  PYTHONPATH=src python -m repro_torch.bench.tuner_bench [--quick]
      [--iters N] [--motifs sort,statistics] [--run] [--workers N]
      [--sweep] [--priors] [--out PATH] [--trace PATH]
      [--device cuda|cpu] [--substrate torch|hopper]

``--trace`` runs the mode with a live telemetry hub as the process
default and exports it as Chrome trace-event JSON (summarise it with
``repro_torch.bench.trace_summary``).  ``--device`` (CUDA by default)
and ``--substrate`` (``hopper``: the chains' sort, matrix and statistics
nodes on the kernels) are the port's own flags.

The JSON document (``--out``) holds the reference's keys, mode by mode
(:data:`DOC_KEYS`); single mode's ``population`` holds the port's
``modes`` as well (each class's vmap or lane-by-lane mode).  Exit status
is nonzero on any parity, cache or priors regression.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List

from repro_torch.bench._io import write_json
from repro_torch.core.cluster import quantize_proxy
from repro_torch.core.evaluator import (
    BatchEvaluator,
    EvalSession,
    serial_evaluate_batch,
)
from repro_torch.core.motifs import PVector
from repro_torch.core.motifs.base import SUBSTRATES
from repro_torch.core.proxy_graph import ProxyBenchmark, linear_chain
from repro_torch.core.tuner import (DecisionTreeTuner, apply_move, encode,
                                    movable_params)
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import MeshShape

SMALL_P = PVector(data_size=1 << 10, chunk_size=1 << 6, num_tasks=2,
                  batch_size=2, height=8, width=8, channels=4)

#: the five-workload mini-sweep: paper-style motif chains, per-workload
#: data characteristics.  alexnet/inception share a chain and differ only
#: in lifted knobs (sparsity, dist_scale); kmeans is the paper's §IV-A
#: sparse case study.
SWEEP = {
    "terasort": ([("sort", "quick"), ("sampling", "random"),
                  ("statistics", "average")], {}),
    "kmeans": ([("matrix", ""), ("statistics", "average")],
               {"distribution": "normal", "sparsity": 0.9}),
    "pagerank": ([("graph", ""), ("statistics", "average")],
                 {"distribution": "zipf"}),
    "alexnet": ([("transform", ""), ("matrix", ""),
                 ("statistics", "average")], {"distribution": "normal"}),
    "inception_v3": ([("transform", ""), ("matrix", ""),
                      ("statistics", "average")],
                     {"distribution": "normal", "sparsity": 0.3,
                      "dist_scale": 2.0}),
}

#: the --priors chain: one compute-dense motif next to two streaming ones,
#: so the shifted-mix target moves dot_flops_frac / arith_intensity past
#: the tolerance
PRIOR_CHAIN = ("matrix", "sort", "statistics")

#: the qualification profile's mesh: a 4-way batch axis
QUANTUM4_MESH = MeshShape(("data",), (4,))

#: the reference document's keys, mode by mode ("" the top level, a dotted
#: name a nested block)
DOC_KEYS = {
    "single": {"": ("mode", "serial_iter_s", "batched_iter_s", "speedup",
                    "parity_gap", "engine", "population", "qualification"),
               "population": ("wall_time", "classes", "candidates",
                              "compiles"),
               "qualification": ("quantum", "raw_rate", "rounded_rate")},
    "sweep": {"": ("mode", "workloads", "iters", "separate", "shared",
                   "compile_reduction", "speedup"),
              "separate": ("wall_s", "compiles"),
              "shared": ("wall_s", "compiles", "cross_workload_hits",
                         "stats", "per_workload")},
    "priors": {"": ("mode", "motifs", "tol", "max_iters", "metrics",
                    "cold", "prior", "eval_reduction", "iter_delta"),
               "cold": ("qualified", "iters_to_tol", "evals_to_tol",
                        "iterations", "evals", "mean_accuracy", "wall_s"),
               "prior": ("qualified", "iters_to_tol", "evals_to_tol",
                         "iterations", "evals", "mean_accuracy", "wall_s",
                         "prior_params")},
}
TRACE_KEYS = ("path", "events", "spans_dropped", "span_names")


def missing_keys(doc: Dict[str, Any]) -> List[str]:
    """The keys of the reference's document for ``doc["mode"]`` that
    ``doc`` lacks, as paths (``trace`` too when the document has one);
    empty when it has them all."""
    blocks = DOC_KEYS.get(doc.get("mode"), DOC_KEYS["single"])
    out = [k for k in blocks[""] if k not in doc]
    for block, keys in blocks.items():
        if block and isinstance(doc.get(block), dict):
            out += [f"{block}.{k}" for k in keys if k not in doc[block]]
    if "trace" in doc:
        out += [f"trace.{k}" for k in TRACE_KEYS if k not in doc["trace"]]
    return out


def impact_batch(pb: ProxyBenchmark, factor: float = 2.0
                 ) -> List[ProxyBenchmark]:
    """Base + every informative one-at-a-time perturbation — the batch
    ``DecisionTreeTuner.impact_analysis`` submits for ``pb`` — plus
    data-characteristic variants of the first node (lifted knobs: they
    must add zero profiles)."""
    refs = movable_params(pb)
    base_x = encode(pb, refs)
    batch = [pb]
    for i, ref in enumerate(refs):
        for f in (factor, 1.0 / factor):
            moved = apply_move(pb, ref, f)
            if encode(moved, refs)[i] != base_x[i]:
                batch.append(moved)
    n0 = pb.nodes[0].id
    batch.append(pb.with_node(n0, sparsity=0.5))
    batch.append(pb.with_node(n0, dist_scale=2.0))
    return batch


def qualification_profile(batch: List[ProxyBenchmark]) -> Dict[str, float]:
    """Mesh-divisibility of an impact batch under a 4-way quantum: the
    fraction of raw candidates that are ``quantize_proxy`` fixed points,
    and the same after tuner-side rounding (1.0 by construction)."""
    mesh = QUANTUM4_MESH

    def qualified(pb):
        return (quantize_proxy(pb, mesh).shape_signature()
                == pb.shape_signature())

    raw = sum(1 for pb in batch if qualified(pb)) / len(batch)
    rounded_batch = [quantize_proxy(pb, mesh) for pb in batch]
    rounded = sum(1 for pb in rounded_batch if qualified(pb)) / len(batch)
    return {"quantum": 4, "raw_rate": raw, "rounded_rate": rounded}


def parity_gap(a: List[Dict[str, float]], b: List[Dict[str, float]]) -> float:
    """Max |batched - serial| over the profiled metrics.  The rate
    metrics (flops_rate/bytes_rate) come from wall clocks, which the two
    paths take under independent noise; everything else must match
    exactly."""
    gap = 0.0
    for ma, mb in zip(a, b):
        for k in set(ma) | set(mb):
            if k.endswith("_rate") or k == "wall_time":
                continue
            gap = max(gap, abs(ma.get(k, 0.0) - mb.get(k, 0.0)))
    return gap


def sweep_chains(names, substrate: str = "torch"
                 ) -> Dict[str, ProxyBenchmark]:
    return {
        name: linear_chain(
            name, [(m, v, SMALL_P.replace(substrate=substrate,
                                          **SWEEP[name][1]))
                   for m, v in SWEEP[name][0]])
        for name in names
    }


def run_sweep(args, out_doc) -> int:
    names = list(SWEEP)
    iters = args.iters
    if args.quick:
        names = ["alexnet", "inception_v3"]
        iters = 1
    chains = sweep_chains(names, args.substrate)
    batches = {n: impact_batch(pb) for n, pb in chains.items()}
    total = sum(len(b) for b in batches.values())
    print(f"sweep: {len(names)} workload(s), {total} candidates/iteration, "
          f"{iters} iteration(s), run={args.run}")

    # per-workload engines (the pre-EvalSession behaviour)
    t0 = time.perf_counter()
    sep_results: Dict[str, List[Dict[str, float]]] = {}
    sep_compiles = 0
    for n in names:
        engine = BatchEvaluator(run=args.run, compile_workers=args.workers,
                                device=args.device)
        for _ in range(iters):
            sep_results[n] = engine.evaluate_batch(batches[n])
        sep_compiles += engine.cache.compiles
    sep_wall = time.perf_counter() - t0

    # one shared session across the whole sweep
    t0 = time.perf_counter()
    session = EvalSession(run=args.run, compile_workers=args.workers,
                          substrate=args.substrate, device=args.device)
    shared_results: Dict[str, List[Dict[str, float]]] = {}
    for n in names:
        with session.workload(n):
            for _ in range(iters):
                shared_results[n] = session.evaluate_batch(batches[n])
    shared_wall = time.perf_counter() - t0
    stats = session.stats()

    gap = max(parity_gap(sep_results[n], shared_results[n]) for n in names)
    cross = stats["cross_workload_hits"]
    print("\npath,total_wall_s,total_compiles")
    print(f"per-workload engines,{sep_wall:.2f},{sep_compiles}")
    print(f"shared EvalSession,{shared_wall:.2f},{stats['compiles']}")
    print(f"\ncross-workload hits: {cross}")
    print("per-workload traffic: "
          + "; ".join(f"{n}: {session.workload_stats[n]['compiles']}c/"
                      f"{session.workload_stats[n]['hits']}h"
                      for n in names))
    print(f"compile workers (widest pool): {stats['compile_workers_max']}")
    print(f"parity: max |shared - separate| = {gap:.3e}")

    out_doc.update({
        "mode": "sweep", "workloads": names, "iters": iters,
        "separate": {"wall_s": sep_wall, "compiles": sep_compiles},
        "shared": {"wall_s": shared_wall, "compiles": stats["compiles"],
                   "cross_workload_hits": cross, "stats": stats,
                   "per_workload": {n: dict(session.workload_stats[n])
                                    for n in names}},
        "compile_reduction": 1.0 - stats["compiles"] / max(sep_compiles, 1),
        "speedup": sep_wall / max(shared_wall, 1e-9),
    })

    if gap > 0.0:
        print("FAIL: shared-session metrics diverge from per-workload engines")
        return 1
    if stats["compiles"] >= sep_compiles:
        print("FAIL: shared session did not reduce total compiles "
              f"({stats['compiles']} vs {sep_compiles})")
        return 1
    if cross == 0:
        print("FAIL: zero cross-workload cache hits — the shared session "
              "is not amortizing profiles across workloads")
        return 1
    print(f"OK: {sep_compiles} -> {stats['compiles']} compiles "
          f"({out_doc['compile_reduction']:.0%} fewer), "
          f"sweep wall {sep_wall:.2f}s -> {shared_wall:.2f}s")
    return 0


def run_priors(args, out_doc) -> int:
    """Prior-seeded vs cold-start tuning on one shared engine.  The target
    is the same chain with the matrix node's data volume shifted
    (data_size x8, weight 2.0), reachable exactly; ``evals`` counts are
    per tuner, so sharing the engine's cache is fair."""
    from repro_torch.core.generator import select_metrics
    from repro_torch.core.priors import elasticity_priors

    # an explicit --iters is the user's budget; 16 gives the cold loop
    # room to converge
    tol = 0.15
    max_iters = args.iters if args.iters is not None else 16
    pb = linear_chain("bench", [(m, "", SMALL_P.replace(
        substrate=args.substrate)) for m in PRIOR_CHAIN])
    tgt_pb = pb.with_node(pb.nodes[0].id,
                          data_size=SMALL_P.data_size * 8, weight=2.0)
    engine = BatchEvaluator(run=args.run, compile_workers=args.workers,
                            device=args.device)
    target_full = engine.evaluate(tgt_pb)
    metrics = select_metrics(target_full, include_rates=args.run)
    target = {k: target_full.get(k, 0.0) for k in metrics}
    print(f"priors profile: chain={','.join(PRIOR_CHAIN)} "
          f"metrics={metrics} tol={tol} max_iters={max_iters}")

    table = elasticity_priors(pb, metrics)

    def profile(name, priors):
        t0 = time.perf_counter()
        res = DecisionTreeTuner(engine, target, tol=tol,
                                max_iters=max_iters, priors=priors).tune(pb)
        rec = {
            "qualified": res.qualified,
            "iters_to_tol": res.iterations if res.qualified else None,
            "evals_to_tol": res.evals if res.qualified else None,
            "iterations": res.iterations, "evals": res.evals,
            "mean_accuracy": res.mean_accuracy,
            "wall_s": time.perf_counter() - t0,
        }
        print(f"{name:6s} qualified={res.qualified} "
              f"iters={res.iterations} evals={res.evals} "
              f"acc={res.mean_accuracy:.3f} wall={rec['wall_s']:.1f}s")
        return rec

    cold = profile("cold", None)
    prior = profile("prior", table)
    prior["prior_params"] = len(table.covered)

    out_doc.update({
        "mode": "priors", "motifs": list(PRIOR_CHAIN), "tol": tol,
        "max_iters": max_iters, "metrics": list(metrics),
        "cold": cold, "prior": prior,
        "eval_reduction": 1.0 - prior["evals"] / max(cold["evals"], 1),
        "iter_delta": prior["iterations"] - cold["iterations"],
    })

    if not prior["qualified"]:
        print("FAIL: prior-seeded run did not reach tolerance")
        return 1
    if cold["qualified"] and prior["evals"] >= cold["evals"]:
        print(f"FAIL: prior-seeded tuning used {prior['evals']} evaluator "
              f"calls vs {cold['evals']} cold — the prior is not paying "
              f"for itself")
        return 1
    print(f"OK: {cold['evals']} -> {prior['evals']} evaluator calls "
          f"({out_doc['eval_reduction']:.0%} fewer), iterations "
          f"{cold['iterations']} -> {prior['iterations']}")
    return 0


def run_single(args, out_doc) -> int:
    names = [m for m in args.motifs.split(",") if m]
    pb = linear_chain("bench", [(m, "", SMALL_P.replace(
        substrate=args.substrate)) for m in names])
    batch = impact_batch(pb)
    print(f"proxy: {len(pb.nodes)} node(s) [{args.motifs}], "
          f"impact batch = {len(batch)} candidates, "
          f"{args.iters} tuning iteration(s), run={args.run}")
    assert len(batch) >= 8 or args.quick, "need a >=8-candidate batch"

    # serial: profiles every candidate, every iteration (eval form, so
    # its metrics equal the engine's)
    serial_times, serial_ref = [], None
    for _ in range(args.iters):
        t0 = time.perf_counter()
        serial_ref = serial_evaluate_batch(batch, run=args.run, lifted=True,
                                           device=args.device)
        serial_times.append(time.perf_counter() - t0)

    # batched engine: shape-class dedup + LRU cache
    engine = BatchEvaluator(run=args.run, compile_workers=args.workers,
                            device=args.device)
    batch_times, batch_res = [], None
    for _ in range(args.iters):
        t0 = time.perf_counter()
        batch_res = engine.evaluate_batch(batch)
        batch_times.append(time.perf_counter() - t0)

    # vmapped population execution (weight + data knobs all lifted)
    t0 = time.perf_counter()
    pop = engine.population_runtime(batch)
    pop_total = time.perf_counter() - t0

    gap = parity_gap(serial_ref, batch_res)
    serial_avg = sum(serial_times) / len(serial_times)
    batch_avg = sum(batch_times) / len(batch_times)
    speedup = serial_avg / max(batch_avg, 1e-9)

    print("\npath,iter_times_s,avg_s_per_iteration")
    print("serial," + "|".join(f"{t:.2f}" for t in serial_times)
          + f",{serial_avg:.2f}")
    print("batched," + "|".join(f"{t:.2f}" for t in batch_times)
          + f",{batch_avg:.2f}")
    print(f"\nspeedup_per_iteration: {speedup:.1f}x "
          f"(first-iteration: "
          f"{serial_times[0] / max(batch_times[0], 1e-9):.1f}x, "
          f"steady-state: "
          f"{serial_times[-1] / max(batch_times[-1], 1e-9):.1f}x)")
    print(f"engine: {engine.stats()}")
    print(f"population: {pop['candidates']} candidates in {pop['classes']} "
          f"vmapped class(es), exec {pop['wall_time'] * 1e3:.1f}ms "
          f"(incl. build {pop_total:.2f}s)")
    for key, mode in pop["modes"].items():
        print(f"  class {key}: {mode}")
    qual = qualification_profile(batch)
    print(f"qualification ({qual['quantum']}-way quantum): "
          f"raw {qual['raw_rate']:.2f} -> "
          f"rounded {qual['rounded_rate']:.2f}")
    print(f"parity: max |batched - serial| (profiled metrics) = {gap:.3e}")

    out_doc.update({
        "mode": "single", "serial_iter_s": serial_times,
        "batched_iter_s": batch_times, "speedup": speedup,
        "parity_gap": gap, "engine": engine.stats(), "population": pop,
        "qualification": qual,
    })

    if gap > 0.0:
        print("FAIL: batched metrics diverge from serial path")
        return 1
    if qual["rounded_rate"] < 1.0:
        print("FAIL: quantized rounding left an unqualified candidate "
              "(quantize_proxy is not a fixed-point map)")
        return 1
    if speedup < 3.0 and not args.quick:
        print("WARN: speedup below the 3x acceptance target")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="small proxy / 2-workload sweep, fewer iterations")
    ap.add_argument("--iters", type=int, default=None,
                    help="tuning iterations to average over (default 3; "
                         "--priors: max tuning iterations, default 16)")
    ap.add_argument("--motifs", default="sort,statistics",
                    help="comma-separated motif chain for the proxy")
    ap.add_argument("--run", action="store_true",
                    help="also measure wall time per candidate (run=True)")
    ap.add_argument("--workers", type=int, default=None,
                    help="engine profiling threads (default: auto, or "
                         "REPRO_COMPILE_WORKERS)")
    ap.add_argument("--sweep", action="store_true",
                    help="multi-workload sweep: shared EvalSession vs "
                         "per-workload engines")
    ap.add_argument("--priors", action="store_true",
                    help="prior-seeded vs cold-start tuning profile "
                         "(fails unless the prior run needs fewer "
                         "evaluator calls)")
    ap.add_argument("--out", default="",
                    help="write the JSON result document to this path")
    ap.add_argument("--trace", default=None,
                    help="run with a live telemetry hub and export the "
                         "bench as Chrome trace-event JSON here")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--substrate", default="torch", choices=SUBSTRATES,
                    help="hopper: the chains' hot loops on the kernels")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)

    hub = prev_hub = None
    if args.trace:
        from repro_torch.runtime.telemetry import Telemetry, set_default

        # the process default: every engine, session and tuner built by
        # the selected mode inherits this hub
        hub = Telemetry()
        prev_hub = set_default(hub)

    if not args.priors and args.iters is None:
        args.iters = 3
    if args.quick and not (args.sweep or args.priors):
        args.iters = min(args.iters, 2)
        args.motifs = args.motifs.split(",")[0]

    out_doc: Dict = {}
    try:
        if args.priors:
            rc = run_priors(args, out_doc)
        elif args.sweep:
            rc = run_sweep(args, out_doc)
        else:
            rc = run_single(args, out_doc)
    finally:
        if hub is not None:
            set_default(prev_hub)
    if hub is not None:
        n_events = hub.export_trace(args.trace)
        snap = hub.snapshot()
        out_doc["trace"] = {"path": args.trace, "events": n_events,
                            "spans_dropped": snap.get("spans_dropped", 0),
                            "span_names": sorted(snap.get("spans", {}))}
        print(f"trace -> {args.trace} ({n_events} events)")
    missing = missing_keys(out_doc)
    if missing:
        print(f"FAIL: the document lacks {missing}")
        rc = rc or 1
    if args.out:
        write_json(args.out, out_doc)
    return rc


if __name__ == "__main__":
    sys.exit(main())
