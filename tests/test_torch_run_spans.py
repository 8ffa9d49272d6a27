"""The port's run spans (``telemetry.RUN_SPAN_ATTRS``): a frozen proxy's
run and its set-up, as the process's default hub records them.

The proxy is the benchmark's frozen K-means proxy
(``portbench/configs/kmeans.json``), its data cut 64x.  With a live
default hub its runner emits a ``proxy.run`` span holding each node's
``proxy.inputs``/``proxy.forward``/``proxy.apply``, in topological order;
its outputs and its profiled signature (op counts included) are those it
gives with the null hub; and under ``torch.profiler`` each span is also
a profiler range holding the ops it ran (the one-clock rule of
``docs/PORT_OBSERVABILITY.md``), which the op profiler does not count.
The CUDA graph's spans are held on the card.
This module imports no JAX, so its ``cuda`` test runs on a GPU host:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
        -m cuda tests/test_torch_run_spans.py
"""
import ctypes
import dataclasses
import json
import re
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torch_parity import cuda_device  # noqa: F401

from repro_torch.analysis import doc_tables
from repro_torch.core.proxy_graph import ProxyBenchmark
from repro_torch.core.signature import profile_call
from repro_torch.kernels import _build
from repro_torch.runtime import telemetry

REPO = Path(__file__).resolve().parents[1]
OBS_DOC = REPO / "docs" / "OBSERVABILITY.md"
PORT_DOC = REPO / "docs" / doc_tables.PORT_OBS_DOC
CPU = torch.device("cpu")
PHASES = ("proxy.inputs", "proxy.forward", "proxy.apply")


def kmeans_proxy(substrate: str = "torch") -> ProxyBenchmark:
    """The benchmark's frozen K-means proxy at 1/64 of its data."""
    doc = json.loads((REPO / "portbench" / "configs" / "kmeans.json")
                     .read_text())["proxy"]
    for node in doc["nodes"]:
        p = node["p"]
        p["data_size"] = max(int(p["data_size"]) // 64, 256)
        if node["motif"] != "matrix":
            p["batch_size"] = min(int(p["batch_size"]), 2)
    return ProxyBenchmark.from_json(json.dumps(doc)).with_substrate(substrate)


@pytest.fixture
def live_hub():
    """A live hub installed as the process default for the test."""
    hub = telemetry.Telemetry()
    prev = telemetry.set_default(hub)
    try:
        yield hub
    finally:
        telemetry.set_default(prev)


def spans(hub):
    """The hub's completed spans, (name, args) in the order they began."""
    return [(e["name"], e["args"]) for e in
            sorted(hub.trace_events(), key=lambda e: e.get("ts", -1))
            if e["ph"] == "X"]


def doc_rows(doc, heading):
    """[(name, required attrs)] of a table of ``doc``, read as the
    reference's contract test reads its span-kind table."""
    rows = []
    for line in doc_tables.doc_section(doc, heading).splitlines():
        m = re.match(r"^\|\s*`([\w.]+)`\s*\|\s*([^|]*)\|", line.strip())
        if m:
            rows.append((m.group(1),
                         tuple(re.findall(r"`(\w+)`", m.group(2)))))
    return rows


def test_run_span_table_equals_the_docs_and_the_reference_table_stays():
    assert doc_rows(PORT_DOC, doc_tables.RUN_SPAN_TABLE_HEADING) == list(
        telemetry.RUN_SPAN_ATTRS.items())
    assert not set(telemetry.RUN_SPAN_ATTRS) & set(telemetry.SPAN_ATTRS)
    assert doc_rows(OBS_DOC, doc_tables.SPAN_TABLE_HEADING) == list(
        telemetry.SPAN_ATTRS.items())
    assert doc_tables.RUN_SPAN_TABLE_HEADING not in OBS_DOC.read_text()
    names = doc_tables.observability_names(OBS_DOC)["span"]
    assert names == telemetry.SPAN_KINDS + tuple(telemetry.RUN_SPAN_ATTRS)
    src = "\n".join(p.read_text() for p in
                    (REPO / "src" / "repro_torch").rglob("*.py"))
    for name in telemetry.RUN_SPAN_ATTRS:  # a row may not outlive its site
        assert f'span("{name}"' in src, name


@pytest.mark.parametrize("substrate", ["torch", "hopper"])
def test_the_runner_emits_its_phases_per_node_in_order(live_hub, substrate):
    pb = kmeans_proxy(substrate)
    pb.build_fn(CPU)(7)
    got = spans(live_hub)
    assert got[0] == ("proxy.run", {"id": got[0][1]["id"]})
    run_id = got[0][1]["id"]
    want = []
    for node in pb.nodes:
        want += [("proxy.inputs", {"node": node.id, "motif": node.motif}),
                 ("proxy.forward", {"node": node.id}),
                 ("proxy.apply", {"node": node.id, "motif": node.motif,
                                  "variant": node.variant})]
    assert [(n, {k: v for k, v in a.items() if k not in ("id", "parent")})
            for n, a in got[1:]] == want
    assert all(a["parent"] == run_id for _, a in got[1:])
    for name, args in got:
        assert set(telemetry.RUN_SPAN_ATTRS[name]) <= set(args)


def test_outputs_are_bit_identical_with_a_live_hub(live_hub):
    fn = kmeans_proxy().build_fn(CPU)
    on = fn(2 ** 31 + 5)
    telemetry.set_default(telemetry.NULL)
    off = fn(2 ** 31 + 5)
    assert on.keys() == off.keys()
    for node in on:
        assert on[node].keys() == off[node].keys()
        for k in on[node]:
            assert torch.equal(on[node][k], off[node][k]), (node, k)


def test_spans_are_profiler_ranges_holding_their_ops(live_hub):
    fn = kmeans_proxy().build_fn(CPU)
    fn(3)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(3)
    ranges = [e for e in prof.events() if e.name.startswith("proxy.")]
    assert all(e.is_user_annotation for e in ranges)
    assert [e.name for e in ranges] == ["proxy.run"] + list(PHASES) * 3
    run = ranges[0]
    for e in ranges[1:]:
        assert e.cpu_parent is run
        assert (run.time_range.start <= e.time_range.start
                <= e.time_range.end <= run.time_range.end)
    # every op of the run is inside one node's phase
    ops = [e for e in prof.events() if e.name.startswith("aten::")
           and e.cpu_parent is not None and not
           e.cpu_parent.name.startswith("aten::")]
    assert ops and all(e.cpu_parent.name in PHASES for e in ops)
    applies = [e for e in ranges if e.name == "proxy.apply"]
    assert all(any(c.name.startswith("aten::") for c in e.cpu_children)
               for e in applies)


class OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_a_span_dispatches_an_op_only_while_the_profiler_records(live_hub):
    from torch.profiler import ProfilerActivity, profile

    with OpLog() as quiet:
        with live_hub.span("proxy.run"):
            pass
    assert quiet.ops == []
    with profile(activities=[ProfilerActivity.CPU]):
        with OpLog() as loud:
            with live_hub.span("proxy.run"):
                pass
    assert any("record_function" in op for op in loud.ops)
    with telemetry.NULL.span("proxy.run") as sp:
        assert sp is telemetry.NULL_SPAN


def test_profile_call_signature_is_identical_with_a_live_hub(live_hub):
    from torch.profiler import ProfilerActivity, profile

    pb = kmeans_proxy()
    fn = pb.build_eval_fn(CPU)
    lifted = pb.lifted_values(CPU)
    on = profile_call(fn, 11, lifted, device=CPU)
    assert [n for n, _ in spans(live_hub)].count("proxy.run") == 1
    # while torch's profiler records, each span dispatches a range op,
    # which the op profiler leaves out of the run's work
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        recorded = profile_call(fn, 11, lifted, device=CPU)
    assert any(e.name == "proxy.apply" for e in prof.events())
    telemetry.set_default(telemetry.NULL)
    off = profile_call(fn, 11, lifted, device=CPU)
    assert dataclasses.asdict(on) == dataclasses.asdict(off)
    assert dataclasses.asdict(recorded) == dataclasses.asdict(off)
    assert on.raw_cost  # the op counts are part of what is compared


class FakeLib:
    """What ``library()`` reads of a loaded library."""

    def __init__(self, path):
        self.path = path
        for name in list(_build.SIGNATURES) + ["repro_error_string"]:
            setattr(self, name, type("Entry", (), {})())


def test_kernels_load_reports_whether_it_built(live_hub, tmp_path,
                                               monkeypatch):
    compiled = []

    def fake_compile(out_dir):
        compiled.append(out_dir)
        (out_dir / _build.LIB_NAME).write_bytes(b"")
        return ""

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_compile", fake_compile)
    monkeypatch.setattr(ctypes, "CDLL", FakeLib)
    _build.library.cache_clear()
    try:
        first = _build.library()
        _build.library.cache_clear()
        second = _build.library()
    finally:
        _build.library.cache_clear()
        _build._entry.cache_clear()
    assert len(compiled) == 1
    assert first.path == second.path == _build.BUILD_INFO["path"]
    assert _build.BUILD_INFO == {"compiled": False, "path": second.path}
    loads = [a for n, a in spans(live_hub) if n == "kernels.load"]
    assert [a["built"] for a in loads] == [True, False]


@pytest.mark.cuda
def test_a_captured_graph_spans_its_setup_and_replays(cuda_device,
                                                      live_hub):
    from repro_torch.core.signature import CapturedGraph

    fn = kmeans_proxy("hopper").build_fn(cuda_device)
    with CapturedGraph(lambda: fn(5), device=cuda_device) as graph:
        graph.replay()
        torch.cuda.synchronize(cuda_device)
    got = spans(live_hub)
    names = [name for name, _ in got]
    setup = got[names.index("graph.setup")][1]["id"]
    # two warm-ups and the capture, each a run of the proxy
    inside = [name for name, a in got if a.get("parent") == setup]
    assert inside.count("proxy.run") == 3 == names.count("proxy.run")
    replay = got[names.index("graph.replay")][1]["id"]
    assert names.count("graph.replay") == 1
    assert not [name for name, a in got if a.get("parent") == replay]
