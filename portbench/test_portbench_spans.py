"""The reading of the program's run spans (``spans.py``) on the CPU: phases
and idle gaps of a synthetic trace, the coverage check, the ranges of a
real profile of a tiny cell, and the set-up parts of a hub's spans."""
import json

import pytest
import torch

from portbench import devtrace, harness, spans, tiny


def X(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


#: one run of a two-node proxy: n0 (inputs, forward, apply), n1 (inputs,
#: forward, apply); a kernel a phase but n1's forward, which launches none
EVENTS = [
    X("user_annotation", "proxy.run", 0, 100),
    X("user_annotation", "proxy.inputs", 1, 10),
    X("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
    X("user_annotation", "proxy.forward", 12, 2),
    X("cuda_runtime", "cudaMemsetAsync", 13, 1, correlation=2),
    X("user_annotation", "proxy.apply", 20, 30),
    X("cuda_runtime", "cudaLaunchKernel", 21, 1, correlation=3),
    X("cuda_runtime", "cudaLaunchKernel", 22, 1, correlation=4),
    X("user_annotation", "proxy.inputs", 51, 5),
    X("cuda_runtime", "cudaLaunchKernel", 52, 1, correlation=5),
    X("user_annotation", "proxy.forward", 57, 3),
    X("user_annotation", "proxy.apply", 61, 30),
    X("cuda_driver", "cuLaunchKernelEx", 62, 1, correlation=6),
    X("kernel", "gen", 10, 4, correlation=1),
    X("gpu_memset", "Memset", 14, 1, correlation=2),
    X("kernel", "mm", 23, 20, correlation=3),
    X("kernel", "moments", 43, 2, correlation=4),
    X("kernel", "gen", 60, 5, correlation=5),
    X("kernel", "sort", 80, 10, correlation=6),
    X("gpu_user_annotation", "proxy.apply", 23, 22),
    {"ph": "M", "name": "thread_name", "tid": 1, "args": {"name": "main"}},
]
HUB = [{"ph": "X", "name": n, "ts": ts, "args": {"node": node, "id": i}}
       for i, (n, ts, node) in enumerate([
           ("proxy.run", 0, None), ("proxy.inputs", 1, "n0"),
           ("proxy.forward", 12, "n0"), ("proxy.apply", 20, "n0"),
           ("proxy.inputs", 51, "n1"), ("proxy.forward", 57, "n1"),
           ("proxy.apply", 61, "n1")])]


def test_phases_and_gaps_of_a_trace():
    tr = spans.read_trace(EVENTS)
    assert len(tr.device) == 6 and len(tr.ranges) == 7
    assert spans.phase_device_ms(tr, 1) == pytest.approx(
        {"proxy.inputs": 9e-3, "proxy.forward": 1e-3,
         "proxy.apply": 32e-3})
    labels = spans.label_ranges(tr, HUB)
    assert labels[:2] == ["proxy.run", "proxy.inputs n0"]
    assert spans.phase_device_ms(tr, 2, labels) == pytest.approx(
        {"proxy.inputs n0": 2e-3, "proxy.forward n0": 0.5e-3,
         "proxy.apply n0": 11e-3, "proxy.inputs n1": 2.5e-3,
         "proxy.apply n1": 5e-3})
    # gaps begin at 15 (n0's forward is over, the run is open), 45 (in
    # n0's apply) and 65 (in n1's apply)
    assert spans.idle_gaps(tr, labels) == pytest.approx(
        {"proxy.run": 8e-6, "proxy.apply n0": 15e-6,
         "proxy.apply n1": 15e-6})
    assert spans.idle_gaps(tr)["proxy.apply"] == pytest.approx(30e-6)
    assert spans.busy_s(tr) == pytest.approx(42e-6)


def test_an_operation_outside_every_phase_fails_the_run(monkeypatch):
    outside = EVENTS + [X("cuda_runtime", "cudaLaunchKernel", 95, 1,
                          correlation=7), X("kernel", "late", 96, 1,
                                            correlation=7)]
    with pytest.raises(spans.PhasesMissed, match="1 of 7"):
        spans.phase_device_ms(spans.read_trace(outside), 1)
    # a launch on another thread than the phase's is not the phase's
    other = [dict(e, tid=2) if e["args"].get("correlation") == 1
             and e["cat"] == "cuda_runtime" else e for e in EVENTS]
    with pytest.raises(spans.PhasesMissed, match="1 of 6"):
        spans.phase_of_ops(spans.read_trace(other))
    monkeypatch.setattr(spans, "PHASES", ("proxy.inputs", "proxy.forward"))
    with pytest.raises(spans.PhasesMissed, match="3 of 6"):
        spans.phase_device_ms(spans.read_trace(EVENTS), 1)


def test_ranges_of_a_tiny_cell_profiled_on_the_cpu(tmp_path):
    from repro_torch.core.proxy_graph import ProxyBenchmark
    from repro_torch.runtime import telemetry

    cell = harness.load_cell("kmeans.proxy",
                             tiny.tiny_root(tmp_path, ["kmeans.proxy"]))
    pb = ProxyBenchmark.from_json(json.dumps(cell.config["proxy"]))
    fn = pb.build_fn(torch.device("cpu"))
    hub = telemetry.Telemetry()
    prev = telemetry.set_default(hub)
    try:
        tr = spans.profile(lambda: [fn(5) for _ in range(2)],
                           torch.device("cpu"))
    finally:
        telemetry.set_default(prev)
    names = [r[0] for r in tr.ranges]
    assert names == (["proxy.run"] + list(spans.PHASES) * 3) * 2
    labels = spans.label_ranges(tr, hub.trace_events())
    ids = [n.id for n in pb.nodes]
    assert labels[1:4] == [f"{p} {ids[0]}" for p in spans.PHASES]
    assert labels[-1] == f"proxy.apply {ids[-1]}"
    assert tr.device == [] and spans.phase_device_ms(tr, 2) == {}


def test_setup_parts_from_a_hub():
    from repro_torch.runtime import telemetry

    hub = telemetry.Telemetry()
    with hub.span("kernels.load", built=False):
        pass
    with hub.span("graph.setup"):  # a warm-up's first launch loads them
        with hub.span("proxy.apply", node="n0", motif="matrix",
                      variant="euclidean"):
            with hub.span("kernels.load", built=True):
                sum(range(100000))
    ev = hub.trace_events()
    dur = {e["name"]: e["dur"] for e in ev if e["ph"] == "X"}
    loads = [e["dur"] for e in ev if e.get("name") == "kernels.load"]
    got = spans.setup_parts(ev)
    assert got["kernels"] == pytest.approx(sum(loads) * 1e-6)
    assert got["graph"] == pytest.approx(
        (dur["graph.setup"] - loads[1]) * 1e-6)
    assert 0 < got["graph"] < dur["graph.setup"] * 1e-6
    assert spans.setup_parts([]) == {}


def a_run(phase_ms=None, setup_s=None):
    run = harness.RunData(setup_s=6.5, window_s=2.0, run_ms=[1.0],
                          flops_per_run=1.0, peaks={})
    if phase_ms is not None:
        run.spans = spans.RunSpans(phase_ms, setup_s)
    return run


@pytest.mark.parametrize("name,want", [
    ("inputs_ms", 0.25), ("forward_ms", 0.0), ("apply_ms", 1.0),
    ("setup_kernels_s", 0.01), ("setup_graph_s", 0.9)])
def test_span_readers_read_a_run(name, want):
    run = a_run({"proxy.inputs": 0.25, "proxy.forward": 0.0,
                 "proxy.apply": 1.0}, {"kernels": 0.01, "graph": 0.9})
    assert name in spans.METRICS
    assert harness.load_reader(name)(run) == pytest.approx(want)


@pytest.mark.parametrize("name", spans.METRICS)
def test_span_readers_with_nothing_to_read_give_nothing(name):
    # the harness as it stands takes no spans: every reader gives nothing
    assert harness.load_reader(name)(a_run()) is None


def test_run_spans_fill_every_phase_and_leave_out_a_missing_part():
    tr = spans.read_trace([e for e in EVENTS if e["name"] != "gen"])
    got = spans.run_spans(tr, 1, [])
    assert got.phase_ms == pytest.approx(
        {"proxy.inputs": 0.0, "proxy.forward": 1e-3, "proxy.apply": 32e-3})
    assert got.setup_s == {}
    assert harness.load_reader("setup_kernels_s")(a_run(
        got.phase_ms, {"graph": 0.5})) is None


@pytest.mark.parametrize("name", ["kmeans.proxy", "kmeans.proxy_torch"])
def test_a_traced_cpu_run_reads_as_without_spans(name, tmp_path,
                                                 monkeypatch):
    """The harness's traced part, on the CPU: with the default hub null,
    as a benchmark run has it, the profiles its readings come from hold
    no range of a span; with a live hub they find the same products."""
    from repro_torch.core.proxy_graph import ProxyBenchmark
    from repro_torch.runtime import telemetry

    cpu = torch.device("cpu")
    cell = harness.load_cell(name, tiny.tiny_root(tmp_path, [name]))
    proxy = cell.config["proxy"]
    pb = ProxyBenchmark.from_json(json.dumps(proxy)).with_substrate(
        cell.traffic["substrate"])
    fn = pb.build_fn(cpu)
    runner = harness.Runner(fn, 5, cpu)
    profiles = []
    real = devtrace._profile

    def keep(cuda, shapes):
        profiles.append(real(cuda, shapes))
        return profiles[-1]

    monkeypatch.setattr(devtrace, "_profile", keep)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(harness, "inputgen_ms", lambda pb, seed, dev: 0.5)

    def traced():
        del profiles[:]
        tr = harness.trace_run(runner, fn, pb, proxy, 5, cpu, 1e3)
        ranges = [e.name for p in profiles for e in p.events()
                  if e.is_user_annotation]
        return tr, ranges

    assert telemetry.get_default() is telemetry.NULL
    off, ranges = traced()
    assert len(profiles) == 2 and ranges == []
    prev = telemetry.set_default(telemetry.Telemetry())
    try:
        on, live_ranges = traced()
    finally:
        telemetry.set_default(prev)
    assert set(live_ranges) == {"proxy.run", *spans.PHASES}
    assert [(op, s) for op, s, _ in on.products] == [
        (op, s) for op, s, _ in off.products]
    assert (on.replays, on.kernels, on.eager_runs, on.inputgen_ms) == (
        off.replays, off.kernels, off.eager_runs, off.inputgen_ms)
