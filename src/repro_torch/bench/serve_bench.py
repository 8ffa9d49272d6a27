"""Load generator for the proxy-serving layer; port of
``benchmarks/serve_bench.py``.

Drives :class:`~repro_torch.runtime.proxy_server.ProxyServer` over one
shared store-backed :class:`~repro_torch.core.evaluator.EvalSession`
through four phases and emits one JSON document:

1. **cold**: closed-loop pass over every distinct shape class, the
   profile phase.  Separated out so the warm-phase tail is a cache-hit
   tail, not a profile tail.
2. **warm**: closed-loop clients hammering the already-profiled classes
   with interleaved evaluate/signature requests; this phase's per-class
   P50/P95/P99 + TTFR are what ``--check`` gates.
3. **tune**: full ``generate_proxy`` requests in their own phase (one
   tune monopolizes the dispatcher; mixing it into the warm phase would
   poison the evaluate tail with somebody else's work).
4. **open-loop sweep**: evaluates submitted at fixed arrival rates
   regardless of completion; per-rate latency shows where queueing delay
   takes over from service time.

Each phase gets its own ProxyServer (a fresh latency recorder) over the
SAME session: the front-end restarts while the engine stays warm.

``--check`` gates (exit nonzero on any failure):

* **parity**: every warm-phase result is bit-identical to the same proxy
  evaluated through a fresh serial ``EvalSession``.
* **tail**: warm-phase per-class P99 and TTFR under ``--p99-bound`` /
  ``--ttfr-bound`` (tune has its own ``--tune-p99-bound``); warm
  closed-loop throughput at least ``--min-throughput``.
* **warm start**: with ``--store``, the run saved entries
  (``store_saves > 0``), and a **fresh subprocess** replaying the same
  shape classes against the store makes **0 profiles** with
  ``store_hits`` covering every class and imports nothing of ``jax`` or
  ``repro`` (the child is this module's ``--probe-only`` mode, on the
  same device and substrate).

``--trace out.json`` runs the whole bench with a live
:class:`~repro_torch.runtime.telemetry.Telemetry` hub threaded through the
session (every ProxyServer inherits it), exports the Chrome trace-event
JSON at the end (per-request spans decompose into
queue-wait/batch-assembly/service children), and times the warm
batched-evaluate path enabled-vs-disabled; with ``--check`` the measured
overhead gates under ``--trace-overhead-bound`` and
``telemetry.snapshot()`` must superset the session's own ``stats()``
counters.  ``repro_torch.bench.trace_summary`` prints the per-stage wall
breakdown from the exported file.

Beyond the reference's flags: ``--device`` (cuda unless ``cpu`` is
asked for) and ``--substrate`` (``torch``, the default, or ``hopper``:
every pool node's ``PVector.substrate`` and the session's substrate for
tune requests).

Usage:  PYTHONPATH=src python -m repro_torch.bench.serve_bench \\
            [--quick] [--check] [--store DIR] [--trace out.json] \\
            [--out serve_bench.json] [--device cpu] [--substrate hopper]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple

import torch

from repro_torch.bench._io import write_json
from repro_torch.core import EvalSession, ProxyStore
from repro_torch.core.motifs import PVector
from repro_torch.core.motifs.base import SUBSTRATES
from repro_torch.core.proxy_graph import MotifNode, ProxyBenchmark
from repro_torch.device import resolve_device
from repro_torch.runtime import ProxyServer

PROBE_MARK = "SERVE_BENCH_PROBE:"

#: the src directory this package is imported from: the probe child's
#: PYTHONPATH
SRC = Path(__file__).resolve().parents[2]

#: the distinct shape classes in the request pool: small enough that the
#: cold phase stays short, spread over enough motifs that coalesced
#: batches mix classes
POOL_SPECS: Sequence[Tuple[str, int]] = (
    ("sort", 1 << 10), ("sort", 1 << 11),
    ("logic", 1 << 10), ("statistics", 1 << 10),
    ("matrix", 1 << 10), ("transform", 1 << 10),
    ("statistics", 1 << 11), ("logic", 1 << 11),
)

#: the reference document's keys, block by block ("" is the top level).
#: ``tune`` is written with ``--tunes`` > 0, ``trace`` with ``--trace``,
#: ``parity`` with ``--check``, ``warm_start_probe`` with ``--check`` and
#: ``--store``.
DOC_KEYS: Dict[str, Tuple[str, ...]] = {
    "": ("bench", "backend", "config", "cold", "warm", "tune", "open_loop",
         "engine", "trace", "parity", "warm_start_probe", "check"),
    "config": ("quick", "classes", "clients", "per_client", "rates_rps",
               "tunes", "store", "trace"),
    "cold": ("wall_s", "classes", "batches"),
    "warm": ("wall_s", "throughput_rps", "classes", "batches", "errors"),
    "tune": ("classes", "qualified"),
    "trace": ("path", "events", "spans_dropped", "span_names", "overhead"),
    "trace.overhead": ("enabled_s", "disabled_s", "fraction", "reps",
                       "rounds"),
    "parity": ("checked", "mismatches"),
    "warm_start_probe": ("classes", "compiles", "store_hits",
                         "store_invalid"),
    "check": ("checked", "failures"),
}
#: one open-loop row: the rate, then the evaluate class's latency row
#: (``LatencyRecorder.summary``), then the server's batching counters
OPEN_LOOP_KEYS = ("rate_rps", "requests", "achieved_rps", "count", "p50_s",
                  "p95_s", "p99_s", "mean_s", "samples_dropped", "ttfr_s",
                  "batches")


def missing_keys(doc: Dict[str, Any]) -> List[str]:
    """The keys of the reference's document that ``doc`` lacks, as
    paths; empty when it has them all.  Which optional blocks are due is
    read from the document's own ``config`` and ``check``."""
    cfg = doc.get("config", {})
    checked = doc.get("check", {}).get("checked", False)
    due = {"tune": cfg.get("tunes", 0) > 0, "trace": cfg.get("trace"),
           "parity": checked,
           "warm_start_probe": checked and cfg.get("store")}
    out = [k for k in DOC_KEYS[""] if due.get(k, True) and k not in doc]
    for block, keys in DOC_KEYS.items():
        part: Any = doc
        for name in block.split(".") if block else ():
            part = part.get(name) if isinstance(part, dict) else None
        if not block or part is None:
            continue
        out += [f"{block}.{k}" for k in keys if k not in part]
    for i, row in enumerate(doc.get("open_loop", ())):
        out += [f"open_loop[{i}].{k}" for k in OPEN_LOOP_KEYS
                if k not in row]
    return out


def build_pool(quick: bool, substrate: str = "torch"
               ) -> List[ProxyBenchmark]:
    specs = POOL_SPECS[:4] if quick else POOL_SPECS
    pool = []
    for i, (motif, size) in enumerate(specs):
        p = PVector(data_size=size, chunk_size=1 << 6, num_tasks=2,
                    batch_size=2, height=8, width=8, channels=4,
                    substrate=substrate)
        pb = ProxyBenchmark(f"serve_{i}_{motif}",
                            (MotifNode("n0", motif, "", p),))
        pb.validate()
        pool.append(pb)
    return pool


def _tiny_workload(x):
    return torch.sort(x).values * 2.0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def closed_loop(server: ProxyServer, pool: Sequence[ProxyBenchmark],
                clients: int, per_client: int,
                signature_every: int = 5) -> List[Tuple[int, Any]]:
    """``clients`` threads, each submitting ``per_client`` requests
    back-to-back (waiting on each result: classic closed loop).  Every
    ``signature_every``-th request is a signature request.  Returns
    ``(pool_index, result)`` pairs for the evaluate requests so the
    caller can parity-check them."""
    results: List[Tuple[int, Any]] = []
    lock = threading.Lock()
    errors: List[BaseException] = []

    def client(cid: int) -> None:
        for j in range(per_client):
            idx = (cid + j * clients) % len(pool)
            try:
                if signature_every and (j + 1) % signature_every == 0:
                    server.submit_signature(pool[idx]).result()
                else:
                    m = server.submit_evaluate(pool[idx]).result()
                    with lock:
                        results.append((idx, m))
            except BaseException as e:  # noqa: BLE001 — reported by caller
                with lock:
                    errors.append(e)
                return

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def open_loop(session: EvalSession, pool: Sequence[ProxyBenchmark],
              rate: float, n: int) -> Dict[str, Any]:
    """Submit ``n`` evaluates at fixed intervals ``1/rate`` from one
    thread, never waiting: queueing delay is part of the latency."""
    with ProxyServer(session) as server:
        futs = []
        t0 = time.perf_counter()
        for j in range(n):
            target = t0 + j / rate
            delay = target - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            futs.append(server.submit_evaluate(pool[j % len(pool)]))
        for f in futs:
            f.result()
        elapsed = time.perf_counter() - t0
        m = server.metrics()
    row = {"rate_rps": rate, "requests": n,
           "achieved_rps": n / elapsed if elapsed > 0 else 0.0}
    row.update(m["classes"]["evaluate"])
    row["batches"] = m["batches"]
    return row


# ---------------------------------------------------------------------------
# warm-start probe (child process)
# ---------------------------------------------------------------------------

def run_probe(store_dir: str, quick: bool, device: torch.device,
              substrate: str) -> int:
    """Fresh-process warm start: evaluate every pool class against the
    store and print the stats the parent gates on, with the reference
    package's modules this process imported (none, if the port is
    whole)."""
    session = EvalSession(run=False, seed=0, store=ProxyStore(store_dir),
                          device=device)
    pool = build_pool(quick, substrate)
    metrics = [session.evaluate(pb) for pb in pool]
    stats = session.stats()
    modules = sorted({n.split(".")[0] for n in sys.modules}
                     & {"jax", "repro"})
    doc = {"classes": len(pool), "compiles": stats.get("compiles"),
           "store_hits": stats.get("store_hits"),
           "store_invalid": stats.get("store_invalid"),
           "modules": modules, "metrics": metrics}
    print(PROBE_MARK + json.dumps(doc, default=float))
    return 0


def spawn_probe(store_dir: str, quick: bool, device: torch.device,
                substrate: str) -> Dict[str, Any]:
    cmd = [sys.executable, "-m", "repro_torch.bench.serve_bench",
           "--probe-only", "--store", store_dir, "--device", device.type,
           "--substrate", substrate] + (["--quick"] if quick else [])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         check=True)
    for line in out.stdout.splitlines():
        if line.startswith(PROBE_MARK):
            return json.loads(line[len(PROBE_MARK):])
    raise RuntimeError(f"probe produced no stats line:\n{out.stdout}\n"
                       f"{out.stderr}")


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="smoke sizes: 4 shape classes, fewer requests")
    ap.add_argument("--check", action="store_true",
                    help="gate parity, tail latency, and (with --store) "
                         "cross-process warm start; exit nonzero on any "
                         "failure")
    ap.add_argument("--store", default=None,
                    help="persistent ProxyStore directory (enables the "
                         "warm-start probe)")
    ap.add_argument("--out", default=None,
                    help="write the full bench doc as JSON")
    ap.add_argument("--clients", type=int, default=4,
                    help="closed-loop client threads")
    ap.add_argument("--requests", type=int, default=None,
                    help="requests per client (default 12, 6 with "
                         "--quick)")
    ap.add_argument("--rates", default=None,
                    help="open-loop arrival rates, req/s (comma list; "
                         "default 4,16 — 8 only with --quick)")
    ap.add_argument("--tunes", type=int, default=1,
                    help="tune requests in the tune phase")
    ap.add_argument("--p99-bound", type=float, default=2.0,
                    help="warm-phase per-class P99 bound, seconds "
                         "(evaluate + signature)")
    ap.add_argument("--ttfr-bound", type=float, default=5.0,
                    help="warm-phase time-to-first-result bound, seconds")
    ap.add_argument("--tune-p99-bound", type=float, default=300.0,
                    help="tune-phase P99 bound, seconds")
    ap.add_argument("--min-throughput", type=float, default=2.0,
                    help="warm closed-loop floor, requests/second")
    ap.add_argument("--trace", default=None,
                    help="run with a live Telemetry hub and export the "
                         "Chrome trace JSON (Perfetto-loadable) here")
    ap.add_argument("--trace-overhead-bound", type=float, default=0.5,
                    help="with --trace --check: max fractional wall "
                         "overhead of the telemetry-enabled warm "
                         "evaluate_batch path vs the untraced run")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--substrate", default="torch", choices=SUBSTRATES,
                    help="the pool's and the tune requests' substrate")
    ap.add_argument("--probe-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.probe_only:
        if not args.store:
            ap.error("--probe-only requires --store")
        return run_probe(args.store, args.quick, dev, args.substrate)

    per_client = args.requests if args.requests is not None else (
        6 if args.quick else 12)
    rates = [float(r) for r in args.rates.split(",")] if args.rates else (
        [8.0] if args.quick else [4.0, 16.0])

    store = ProxyStore(args.store) if args.store else None
    hub = None
    if args.trace:
        from repro_torch.runtime.telemetry import Telemetry

        hub = Telemetry()
    session = EvalSession(run=False, seed=0, store=store, telemetry=hub,
                          substrate=args.substrate, device=dev)
    pool = build_pool(args.quick, args.substrate)
    doc: Dict[str, Any] = {
        "bench": "serve_bench", "backend": dev.type,
        "config": {"quick": args.quick, "classes": len(pool),
                   "clients": args.clients, "per_client": per_client,
                   "rates_rps": rates, "tunes": args.tunes,
                   "store": bool(store), "trace": bool(hub),
                   "device": str(dev), "substrate": args.substrate},
    }
    failures: List[str] = []

    # -- phase 1: cold (the profile pass) -----------------------------------
    print(f"serve_bench: cold phase ({len(pool)} classes)")
    with ProxyServer(session) as server:
        t0 = time.perf_counter()
        closed_loop(server, pool, clients=2, per_client=len(pool),
                    signature_every=0)
        cold_s = time.perf_counter() - t0
        cold = server.metrics()
    doc["cold"] = {"wall_s": cold_s, "classes": cold["classes"],
                   "batches": cold["batches"]}

    # -- phase 2: warm closed loop (the gated tail) -------------------------
    total = args.clients * per_client
    print(f"serve_bench: warm phase ({args.clients} clients x "
          f"{per_client} requests)")
    with ProxyServer(session) as server:
        t0 = time.perf_counter()
        warm_results = closed_loop(server, pool, args.clients, per_client)
        warm_s = time.perf_counter() - t0
        warm = server.metrics()
    warm_rps = total / warm_s if warm_s > 0 else 0.0
    doc["warm"] = {"wall_s": warm_s, "throughput_rps": warm_rps,
                   "classes": warm["classes"], "batches": warm["batches"],
                   "errors": warm["errors"]}

    # -- phase 3: tune ------------------------------------------------------
    if args.tunes > 0:
        print(f"serve_bench: tune phase ({args.tunes} requests)")
        # built before submitting: no client allocates on the device
        # while the dispatcher profiles
        x = torch.arange(512, dtype=torch.float32, device=dev).flip(0)
        with ProxyServer(session) as server:
            futs = [server.submit_tune(_tiny_workload, x,
                                       name=f"serve_tune_{i}", max_iters=2)
                    for i in range(args.tunes)]
            reports = [f.result() for f in futs]
            tune = server.metrics()
        doc["tune"] = {"classes": tune["classes"],
                       "qualified": [rep.qualified for _, rep in reports]}

    # -- phase 4: open-loop arrival-rate sweep ------------------------------
    doc["open_loop"] = []
    for rate in rates:
        n = max(len(pool), int(rate * (1.5 if args.quick else 3.0)))
        print(f"serve_bench: open loop at {rate:g} req/s ({n} requests)")
        doc["open_loop"].append(open_loop(session, pool, rate, n))

    doc["engine"] = session.stats()

    # -- trace export + overhead probe --------------------------------------
    if hub is not None:
        from repro_torch.runtime.telemetry import NULL

        # enabled-vs-disabled overhead on the warm batched-evaluate path:
        # every class is cached, so the loop times engine dispatch (the
        # path the telemetry spans/events decorate), not profiles
        def timed_evals(reps: int) -> float:
            t0 = time.perf_counter()
            for _ in range(reps):
                session.evaluate_batch(pool)
            return time.perf_counter() - t0

        # paired rounds, each timing the enabled path right before the
        # disabled one, and the round with the median ratio.  (The
        # reference compares the fastest round of each mode; on a host
        # whose CPU clock shifts between rounds, that reads the shift as
        # overhead or hides it.)
        reps = 10 if args.quick else 20
        rounds = 3 if args.quick else 5
        pairs = []
        prev_hub = None
        for _ in range(rounds):
            session.set_telemetry(hub)
            timed_evals(2)  # per-round warm-up, outside the measurement
            enabled = timed_evals(reps)
            prev_hub = session.set_telemetry(NULL)
            timed_evals(2)
            pairs.append((enabled, timed_evals(reps)))
        session.set_telemetry(prev_hub)
        pairs.sort(key=lambda p: p[0] / p[1] if p[1] > 0 else 0.0)
        enabled_s, disabled_s = pairs[len(pairs) // 2]
        overhead = ((enabled_s - disabled_s) / disabled_s
                    if disabled_s > 0 else 0.0)

        snapshot = hub.snapshot()
        n_events = hub.export_trace(args.trace)
        doc["trace"] = {
            "path": args.trace, "events": n_events,
            "spans_dropped": snapshot.get("spans_dropped", 0),
            "span_names": sorted(snapshot.get("spans", {})),
            "overhead": {"enabled_s": enabled_s, "disabled_s": disabled_s,
                         "fraction": overhead, "reps": reps,
                         "rounds": rounds},
        }
        print(f"serve_bench: trace -> {args.trace} ({n_events} events), "
              f"telemetry overhead {overhead:+.1%}")

    # -- gates --------------------------------------------------------------
    if args.check:
        # parity: warm results bit-identical to a fresh serial session
        ref_session = EvalSession(run=False, seed=0, device=dev)
        ref = [ref_session.evaluate(pb) for pb in pool]
        bad = sum(1 for idx, m in warm_results if m != ref[idx])
        doc["parity"] = {"checked": len(warm_results), "mismatches": bad}
        if bad:
            failures.append(f"parity: {bad}/{len(warm_results)} warm "
                            f"results differ from the serial path")

        for cls, row in warm["classes"].items():
            if row["p99_s"] > args.p99_bound:
                failures.append(f"warm {cls} P99 {row['p99_s']:.3f}s > "
                                f"bound {args.p99_bound}s")
            # ttfr_s is None (strict-JSON null) for a class with a
            # submission but no completed result: in the gated warm
            # phase every class must actually complete
            if row["ttfr_s"] is None:
                failures.append(f"warm {cls}: no completed result "
                                f"(ttfr_s is null)")
            elif row["ttfr_s"] > args.ttfr_bound:
                failures.append(f"warm {cls} TTFR {row['ttfr_s']:.3f}s > "
                                f"bound {args.ttfr_bound}s")
        if warm_rps < args.min_throughput:
            failures.append(f"warm throughput {warm_rps:.2f} req/s < "
                            f"floor {args.min_throughput}")
        if args.tunes > 0:
            trow = doc["tune"]["classes"]["tune"]
            if trow["p99_s"] > args.tune_p99_bound:
                failures.append(f"tune P99 {trow['p99_s']:.3f}s > bound "
                                f"{args.tune_p99_bound}s")

        if store is not None:
            stats = session.stats()
            if stats.get("store_saves", 0) <= 0:
                failures.append("store: no entries saved")
            print("serve_bench: warm-start probe (fresh process)")
            probe = spawn_probe(args.store, args.quick, dev, args.substrate)
            doc["warm_start_probe"] = {k: probe[k] for k in
                                       ("classes", "compiles", "store_hits",
                                        "store_invalid", "modules")}
            if probe["compiles"] != 0:
                failures.append(f"warm start: fresh process profiled "
                                f"{probe['compiles']} eval forms (want 0)")
            if probe["store_hits"] < probe["classes"]:
                failures.append(f"warm start: store hit-rate "
                                f"{probe['store_hits']}/{probe['classes']}")
            if probe["metrics"] != ref:
                failures.append("warm start: probe metrics differ from "
                                "the serial path")
            if probe["modules"]:
                failures.append(f"warm start: the probe imported "
                                f"{probe['modules']}")

        if hub is not None:
            # the traced run must actually observe itself: spans on disk,
            # bounded overhead, and a snapshot that supersets the engine's
            # own counters
            over = doc["trace"]["overhead"]["fraction"]
            if over > args.trace_overhead_bound:
                failures.append(f"telemetry overhead {over:.1%} > bound "
                                f"{args.trace_overhead_bound:.0%}")
            snap_engine = snapshot.get("engine", {})
            for k, v in session.stats().items():
                if snap_engine.get(k) != v:
                    failures.append(f"snapshot engine counter {k!r} = "
                                    f"{snap_engine.get(k)!r}, stats() says "
                                    f"{v!r}")
                    break

    doc["check"] = {"checked": bool(args.check), "failures": failures}
    missing = missing_keys(doc)
    if missing:
        failures.append(f"the document lacks {missing}")
    if args.out:
        write_json(args.out, doc)

    w = doc["warm"]["classes"].get("evaluate", {})
    print(f"serve_bench: warm evaluate P50/P95/P99 = "
          f"{w.get('p50_s', 0):.4f}/{w.get('p95_s', 0):.4f}/"
          f"{w.get('p99_s', 0):.4f}s, throughput {warm_rps:.1f} req/s")
    if failures:
        for f in failures:
            print(f"CHECK FAIL: {f}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
