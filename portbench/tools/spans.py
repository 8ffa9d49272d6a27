"""One cell's run, set up with the program's telemetry hub live, and what
its run spans show (``portbench/spans.py``), the readings of
``spans.METRICS`` among them; no metric of ``BENCHMARK.json`` lists
those yet.

    python3 portbench/tools/spans.py --workload kmeans.proxy --seed 7 \
        --seconds 10

Set-up is the harness's (``harness.Runner`` after ``import_program``),
with a live ``Telemetry`` as the process default from the start; the
spans committed by the first run's end give its parts, and the host
clock marks the imports' end and ``build_fn``'s.  The window runs
with the null hub, as the benchmark's runs do.  Then three profiled
parts, each with the hub as named:

* ``replays_null``: back-to-back replays as ``harness.trace_run`` takes
  them (``devtrace.reduce``), busy time a replay;
* ``replays_live``: the same replays, idle gaps by ``graph.replay`` or
  no span;
* ``eager``: ``harness.EAGER_RUNS`` eager runs, device ms a run by phase
  and by phase and node, idle gaps by phase and node; fails
  (``spans.PhasesMissed``) if a device operation was launched outside
  every phase.

The readers of ``spans.METRICS`` read the eager part and the set-up's
spans (``spans.run_spans``); each node's motif and variant come from its
``proxy.apply`` span, and whether set-up built the kernels' library from
``kernels.load``.  Last, the hub's cost on the host, the hub live and
null in turns: eager runs timed on the host clock to the end of their
launches (each after a synchronise), and a span such as the runner's
alone.  Prints the idle gaps and the set-up's parts on standard error,
and one JSON line on standard output with the card's name and power
limit in it.

The tool stands in for ``harness.run_cell``, which takes no spans: once
it does (``PERF.md`` §7), this tool and ``spans_call.sh`` are deleted.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
#: turns of the cost probe, and eager runs and lone spans a turn
COST_TURNS, COST_RUNS, COST_SPANS = 8, 10, 2000


def host_us(fn, seed, runs, device, torch):
    """Median host microseconds from an eager run's call to the return of
    its last launch, each run started on an idle device."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn(seed)
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize(device)
    return statistics.median(times)


def span_us(hub, spans):
    """Host microseconds of one span such as the runner's, entered and
    left ``spans`` times on ``hub``."""
    t0 = time.perf_counter()
    for _ in range(spans):
        with hub.span("proxy.apply", node="n0", motif="matrix",
                      variant="euclidean"):
            pass
    return (time.perf_counter() - t0) * 1e6 / spans


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from portbench import run as bench_run

    for var, sub in bench_run.CACHE_DIRS.items():
        os.environ[var] = str(bench_run.CACHE / sub)
    import torch

    from portbench import counts, devtrace, harness, reference, spans

    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    harness.import_program(cell.root)
    from repro_torch.core.proxy_graph import ProxyBenchmark
    from repro_torch.runtime import telemetry

    t_imports = time.perf_counter()
    hub = telemetry.Telemetry()
    telemetry.set_default(hub)
    seed = args.seed % (1 << 63)
    pb = ProxyBenchmark.from_json(json.dumps(cell.config["proxy"])
                                  ).with_substrate(cell.traffic["substrate"])
    fn = pb.build_fn(device)
    t_built = time.perf_counter()
    runner = harness.Runner(fn, seed, device)
    runner()
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START
    setup_events = hub.trace_events()
    telemetry.set_default(telemetry.NULL)

    window_s, run_ms = harness.measure(runner, args.seconds, device,
                                       harness.INFLIGHT)
    proxy_ms = window_s * 1e3 / len(run_ms)
    replays = harness._replays(proxy_ms)

    def replay():
        for _ in range(replays):
            runner()

    null = devtrace.reduce(devtrace.timeline(replay, device), replays)
    telemetry.set_default(telemetry.Telemetry())
    live = spans.profile(replay, device)

    eager_hub = telemetry.Telemetry()
    telemetry.set_default(eager_hub)

    def eager():
        for _ in range(harness.EAGER_RUNS):
            fn(seed)

    eg = spans.profile(eager, device)
    data = harness.RunData(setup_s, window_s, run_ms,
                           reference.flops(cell.config["proxy"]),
                           counts.PEAKS)
    data.spans = spans.run_spans(eg, harness.EAGER_RUNS, setup_events)
    metrics = {name: harness.load_reader(name, cell.root)(data)
               for name in spans.METRICS}
    phases, parts = data.spans.phase_ms, data.spans.setup_s
    eager_events = eager_hub.trace_events()
    labels = spans.label_ranges(eg, eager_events)
    by_node = spans.phase_device_ms(eg, harness.EAGER_RUNS, labels)
    eager_gaps = spans.idle_gaps(eg, labels)
    live_gaps = spans.idle_gaps(live)

    cost = {"null": [], "live": []}
    per_span = {"null": [], "live": []}
    for turn in range(COST_TURNS):
        for side in (("null", "live") if turn % 2 == 0 else ("live", "null")):
            telemetry.set_default(telemetry.NULL if side == "null"
                                  else telemetry.Telemetry())
            cost[side].append(host_us(fn, seed, COST_RUNS, device, torch))
            per_span[side].append(span_us(telemetry.get_default(),
                                          COST_SPANS))
    telemetry.set_default(telemetry.NULL)
    mode = runner.mode
    runner.close()

    busy_ms = null.busy_s * 1e3 / replays
    total = sum(phases.values())
    result = {
        "cell": cell.name, "seed": seed, "mode": mode, "metrics": metrics,
        "setup_s": setup_s, "setup_parts_s": parts,
        "setup_rest_s": setup_s - sum(parts.values()),
        "setup_marks_s": {"imports": t_imports - T_START,
                          "build_fn": t_built - t_imports,
                          "runner": setup_s - (t_built - T_START)},
        "setup_spans": len([e for e in setup_events if e["ph"] == "X"]),
        "kernels_built": [e["args"]["built"] for e in setup_events
                          if e.get("name") == "kernels.load"],
        "proxy_ms": proxy_ms, "replays": replays,
        "launches_per_run": null.kernels / replays,
        "busy_ms_per_replay": busy_ms,
        "busy_ms_per_replay_live": spans.busy_s(live) * 1e3 / replays,
        "phase_ms": phases, "phase_ms_sum": total,
        "phase_sum_over_busy": total / busy_ms,
        "phase_node_ms": by_node,
        "nodes": {e["args"]["node"]: [e["args"]["motif"],
                                      e["args"]["variant"]]
                  for e in eager_events if e.get("name") == "proxy.apply"},
        "eager_busy_ms_per_run": spans.busy_s(eg) * 1e3 / harness.EAGER_RUNS,
        "idle_s": {"replays_null": dict(null.idle_gaps),
                   "replays_live": live_gaps, "eager": eager_gaps},
        "host_us_per_eager_run": {m: statistics.median(v)
                                  for m, v in cost.items()},
        "host_us_turns": cost,
        "host_us_per_span": {m: statistics.median(v)
                             for m, v in per_span.items()},
        "card": bench_run.card(),
    }
    for part, gaps in result["idle_s"].items():
        harness.log(f"spans: idle {part}: " + ", ".join(
            f"{k} {v:.6f} s" for k, v in sorted(gaps.items(),
                                                 key=lambda kv: -kv[1])))
    harness.log(f"spans: setup_s {setup_s:.3f} = {parts} + rest "
                f"{result['setup_rest_s']:.3f}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
