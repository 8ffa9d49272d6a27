"""The port's telemetry hub (``repro_torch.runtime.telemetry``) against the
reference's (``repro.runtime.telemetry``) on the same scripted sequence,
and the spans the port's engine emits.

Span durations are wall-clock and differ between hubs; everything else a
snapshot holds — span names and counts, event counts, counters, gauges,
histogram summaries (nearest-rank percentiles over a bounded ring with
exact totals), drop counts — must be equal, floats exactly.
"""
import json
import math

import numpy as np
import pytest

from repro.runtime import telemetry as jtel
from repro_torch.core import EvalSession, ProxyStore, generate_proxy
from repro_torch.core.motifs import PVector
from repro_torch.core.proxy_graph import linear_chain
from repro_torch.runtime import telemetry as ttel
from repro_torch.workloads import WORKLOADS

#: the spans and events the port's engine, tuner and decompose emit
PORT_SPANS = {"decompose", "tune.impact", "tune.iteration", "eval.batch",
              "eval.trace", "eval.compile", "eval.execute", "store.load",
              "store.save"}
PORT_EVENTS = {"cache.hit", "cache.store_hit", "cache.store_invalid"}


def _script(mod, seed: int):
    """The same spans, events and metrics on a hub of module ``mod``."""
    hub = mod.Telemetry(span_capacity=64, hist_samples=16)
    rng = np.random.default_rng(seed)
    for i in range(5):
        with hub.span("eval.batch", candidates=i) as sp:
            with hub.span("eval.compile", key=f"k{i}"):
                hub.event("cache.hit", key=f"k{i}")
            sp.set(done=True)
    hub.add_span("serve.queue_wait", 1.0, 1.5, parent=None)
    hub.event("cache.store_hit", key="s")
    hub.counter("evals").inc(3)
    hub.counter("evals").inc()
    hub.gauge("entries").set(7)
    hist = hub.histogram("latency_ms")
    for v in rng.gamma(2.0, 3.0, size=40):
        hist.observe(float(v))
    hub.register_provider("engine", lambda: {"hits": 2, "misses": 1})
    return hub


def _structure(snap: dict) -> dict:
    """A snapshot without its wall-clock durations."""
    out = dict(snap)
    out["spans"] = {k: v["count"] for k, v in snap["spans"].items()}
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_scripted_snapshot_equals_the_reference(seed):
    got = _script(ttel, seed).snapshot()
    want = _script(jtel, seed).snapshot()
    assert _structure(got) == _structure(want)
    assert got["histograms"]["latency_ms"]["dropped"] == 24
    assert got["spans"]["eval.batch"]["count"] == 5
    for agg in got["spans"].values():
        assert 0.0 <= agg["max_s"] <= agg["wall_s"]


def test_kind_tables_equal_the_reference():
    assert ttel.SPAN_ATTRS == jtel.SPAN_ATTRS
    assert ttel.EVENT_ATTRS == jtel.EVENT_ATTRS
    assert ttel.METRIC_KINDS == jtel.METRIC_KINDS
    assert ttel.PERCENTILES == jtel.PERCENTILES
    assert ttel.RESERVED_SECTIONS == jtel.RESERVED_SECTIONS
    assert PORT_SPANS <= set(ttel.SPAN_KINDS)
    assert PORT_EVENTS == set(ttel.EVENT_KINDS)


def test_null_hub_is_a_shared_noop():
    null = ttel.NULL
    assert null.enabled is False and isinstance(null, ttel.NullTelemetry)
    assert null.span("eval.batch", candidates=3) is ttel.NULL_SPAN
    with null.span("eval.compile", key="x") as sp:
        assert sp.set(hit=True) is ttel.NULL_SPAN
    assert null.add_span("serve.request", 0.0, 1.0, cls="evaluate") is None
    assert null.event("cache.hit", key="x") is None
    for get in (null.counter, null.gauge, null.histogram):
        assert get("m") is ttel.NULL_METRIC
    null.counter("c").inc()
    null.histogram("h").observe(1.0)
    assert null.snapshot() == {}
    assert null.export_trace("/nonexistent/never/written") is None
    with pytest.raises(RuntimeError):
        with null.span("eval.batch", candidates=1):
            raise RuntimeError("boom")


def test_set_default_round_trips():
    hub = ttel.Telemetry()
    prev = ttel.set_default(hub)
    try:
        assert ttel.get_default() is hub
    finally:
        assert ttel.set_default(prev) is hub
    assert ttel.get_default() is prev
    prev2 = ttel.set_default(None)  # None installs NULL, never None
    try:
        assert ttel.get_default() is ttel.NULL
    finally:
        ttel.set_default(prev2)


@pytest.mark.parametrize("capacity,emitted", [(4, 10), (8, 8), (1, 3)])
def test_span_ring_drops_oldest_and_counts(capacity, emitted):
    def run(mod):
        hub = mod.Telemetry(span_capacity=capacity)
        for i in range(emitted):
            with hub.span("eval.batch", candidates=i):
                pass
        return hub

    got, want = run(ttel), run(jtel)
    assert got.spans_dropped == want.spans_dropped == emitted - min(
        capacity, emitted)
    assert got.snapshot()["spans_dropped"] == got.spans_dropped
    assert [e["args"]["candidates"] for e in got.trace_events()
            if e["ph"] == "X"] == list(range(emitted))[-capacity:]


def test_exported_trace_is_valid_chrome_json(tmp_path):
    hub = _script(ttel, 0)
    path = tmp_path / "trace.json"
    n = hub.export_trace(str(path))
    doc = json.loads(path.read_text())
    assert n == len(doc["traceEvents"]) > 0
    assert doc["displayTimeUnit"] == "ms"
    assert doc["metadata"]["trace_version"] == jtel.TRACE_VERSION
    phases = {e["ph"] for e in doc["traceEvents"]}
    assert phases == {"M", "X", "i"}
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            assert e["dur"] >= 0.0 and "id" in e["args"]
    # children name their parent span
    ids = {e["args"]["id"]: e["name"] for e in doc["traceEvents"]
           if e["ph"] == "X"}
    compiles = [e for e in doc["traceEvents"] if e["name"] == "eval.compile"]
    assert all(ids[e["args"]["parent"]] == "eval.batch" for e in compiles)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["trace.json"]


def test_export_trace_refuses_nan(tmp_path):
    hub = ttel.Telemetry()
    with hub.span("eval.batch", candidates=1, worst=math.nan):
        pass
    with pytest.raises(ValueError):
        hub.export_trace(str(tmp_path / "t.json"))
    assert list(tmp_path.iterdir()) == []


def test_metric_kinds_are_sticky_and_providers_reserved():
    hub = ttel.Telemetry()
    hub.counter("x")
    with pytest.raises(TypeError):
        hub.gauge("x")
    with pytest.raises(ValueError):
        hub.register_provider("spans", dict)
    hub.register_provider("broken", lambda: 1 / 0)
    assert "provider_error" in hub.snapshot()["broken"]


def _kmeans_proxy(session=None, **kw):
    w = WORKLOADS["kmeans"]
    args = w.inputs(seed=0, scale=0.005, device="cpu")
    return generate_proxy(
        w.step, *args, name="km", hints=w.hints,
        base_p=PVector(data_size=2 ** 11, chunk_size=64, num_tasks=2),
        max_iters=2, run=False, device="cpu", session=session, **kw)


def test_generate_proxy_metrics_are_bit_identical_with_a_live_hub(tmp_path):
    pb_off, off = _kmeans_proxy(EvalSession(run=False, device="cpu"))
    hub = ttel.Telemetry()
    session = EvalSession(run=False, device="cpu", telemetry=hub,
                          store=ProxyStore(str(tmp_path)))
    pb_on, on = _kmeans_proxy(session)
    assert on.proxy_metrics == off.proxy_metrics
    assert on.per_metric_accuracy == off.per_metric_accuracy
    assert on.trace == off.trace and on.evals == off.evals
    assert pb_on.to_json() == pb_off.to_json()
    snap = hub.snapshot()
    assert snap["engine"] == session.stats()  # the provider contract
    assert set(snap["spans"]) <= set(ttel.SPAN_KINDS)
    need = {"decompose", "tune.impact", "eval.batch", "eval.trace",
            "eval.compile", "store.load", "store.save"}
    assert need <= set(snap["spans"])
    assert snap["spans"]["eval.compile"]["count"] == session.stats()[
        "compiles"]
    assert snap["spans"]["tune.iteration"]["count"] == on.iterations
    assert snap["events"]["cache.hit"] == session.stats()["hits"]
    # a second traced session on the same store is served from it
    again = EvalSession(run=False, device="cpu", telemetry=hub,
                        store=ProxyStore(str(tmp_path)))
    again.evaluate(pb_on)
    assert hub.snapshot()["events"]["cache.store_hit"] == 1


def test_set_telemetry_swaps_the_session_hub():
    session = EvalSession(run=False, device="cpu")
    assert session.telemetry is ttel.get_default()
    hub = ttel.Telemetry()
    prev = session.set_telemetry(hub)
    assert prev is ttel.get_default() and session.telemetry is hub
    assert session.engine.telemetry is hub
    session.evaluate(linear_chain("one", [("sort", "quick",
                                           PVector(data_size=1024))]))
    assert hub.snapshot()["engine"] == session.stats()
    assert hub.snapshot()["spans"]["eval.compile"]["count"] == 1
    assert session.set_telemetry(None) is hub
    assert session.telemetry is ttel.NULL
