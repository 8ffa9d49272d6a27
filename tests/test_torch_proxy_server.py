"""The port's ``ProxyServer`` (``repro_torch.runtime.proxy_server``): the
reference's own tests of it (``tests/test_proxy_server.py``) run against
the port on the CPU, and the port held against the reference — the
percentile rule and the latency recorder on the same streams, the
coalescing of the same burst, the request classes and span names the
docs table.
"""
import json
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import EvalSession as JEvalSession
from repro.core.motifs import PVector as JPVector
from repro.core.proxy_graph import MotifNode as JMotifNode
from repro.core.proxy_graph import ProxyBenchmark as JProxyBenchmark
from repro.runtime import proxy_server as jserver
from repro_torch.core import EvalSession, ProxyStore
from repro_torch.core.motifs import PVector
from repro_torch.core.motifs.base import DEFAULT_EVAL_BATCH
from repro_torch.core.proxy_graph import MotifNode, ProxyBenchmark
from repro_torch.runtime import (
    PERCENTILES,
    REQUEST_CLASSES,
    LatencyRecorder,
    ProxyServer,
    ServerClosed,
    Telemetry,
    percentile,
)
from repro_torch.runtime import proxy_server as tserver

DOCS = Path(__file__).resolve().parents[1] / "docs"
P = dict(data_size=1 << 10, chunk_size=1 << 6, num_tasks=2, batch_size=2,
         height=8, width=8, channels=4)


def _pb(motif="sort", **updates) -> ProxyBenchmark:
    pb = ProxyBenchmark(f"t_{motif}", (MotifNode(
        "n0", motif, "", PVector(**P).replace(**updates)),))
    pb.validate()
    return pb


def _jpb(motif="sort", **updates) -> JProxyBenchmark:
    pb = JProxyBenchmark(f"t_{motif}", (JMotifNode(
        "n0", motif, "", JPVector(**P).replace(**updates)),))
    pb.validate()
    return pb


POOL = [_pb("sort"), _pb("logic"), _pb("sort", data_size=1 << 11),
        _pb("statistics")]


def _session(**kw) -> EvalSession:
    return EvalSession(run=False, seed=0, device="cpu", **kw)


def _tiny_workload(x):
    return torch.sort(x).values * 2.0


class NotAProxy:
    pass


# ---------------------------------------------------------------------------
# the reference's tests, against the port
# ---------------------------------------------------------------------------

def test_concurrent_submits_bit_identical_to_serial():
    ref_sess = _session()
    ref = [ref_sess.evaluate(pb) for pb in POOL]

    with ProxyServer(_session(), max_batch=8) as srv:
        futs = {}
        lock = threading.Lock()

        def client(cid):
            for j in range(3):
                idx = (cid + j) % len(POOL)
                f = srv.submit_evaluate(POOL[idx])
                with lock:
                    futs[(cid, j)] = (idx, f)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for idx, f in futs.values():
            assert f.result(timeout=300) == ref[idx]  # bit-identical

    m = srv.metrics()
    assert m["requests"] == 12
    assert m["errors"] == 0
    # the engine profiled each shape class at most once
    assert m["engine"]["compiles"] <= len(POOL)


def test_interleaved_tune_and_evaluate_through_one_session():
    x = torch.arange(256, dtype=torch.float32).flip(0)
    ref_eval = _session().evaluate(POOL[0])

    with ProxyServer(_session()) as srv:
        f_tune = srv.submit_tune(_tiny_workload, x, name="w", max_iters=2)
        f_evals = [srv.submit_evaluate(POOL[0]) for _ in range(3)]
        f_sig = srv.submit_signature(POOL[0])
        pb_t, rep = f_tune.result(timeout=600)
        assert rep.name == "w" and rep.device == "cpu"
        for f in f_evals:
            assert f.result(timeout=300) == ref_eval
        assert f_sig.result(timeout=300).flops > 0

    rows = srv.metrics()["classes"]
    assert set(rows) == {"tune", "evaluate", "signature"}
    for row in rows.values():
        assert row["count"] >= 1
        assert row["p99_s"] >= row["p50_s"] >= 0.0
        assert row["ttfr_s"] >= 0.0


def test_batched_requests_match_singles():
    """Requests coalesced into one engine batch return exactly what
    one-at-a-time submission returns."""
    singles_sess = _session()
    singles = [singles_sess.evaluate(pb) for pb in POOL]

    srv = ProxyServer(_session(), max_batch=8)
    # submit everything BEFORE starting the dispatcher so the whole
    # queue coalesces into one batch
    futs = [srv.submit_evaluate(pb) for pb in POOL]
    srv.start()
    got = [f.result(timeout=300) for f in futs]
    srv.shutdown()
    assert got == singles
    assert srv.metrics()["batches"]["max_size"] == len(POOL)


@pytest.mark.parametrize("coalesced", [False, True],
                         ids=["own_future", "inside_coalesced_batch"])
def test_raising_request_is_isolated(coalesced):
    """A poisoned request fails only its own future, whether it runs
    alone or rides in a coalesced batch (the per-request fallback)."""
    ref = _session().evaluate(POOL[0])
    srv = ProxyServer(_session(), max_batch=8)
    if not coalesced:
        srv.start()
    f_before = srv.submit_evaluate(POOL[0])
    f_bad = srv.submit_evaluate(NotAProxy())
    f_after = srv.submit_evaluate(POOL[0] if coalesced else POOL[1])
    srv.start()
    assert f_before.result(timeout=300) == ref
    assert f_after.result(timeout=300)
    with pytest.raises(Exception):
        f_bad.result(timeout=300)
    srv.shutdown()
    assert srv.metrics()["errors"] == 1


@pytest.mark.parametrize("drain", [True, False])
def test_shutdown_drains_or_cancels_queued_requests(drain):
    srv = ProxyServer(_session())
    futs = [srv.submit_evaluate(pb) for pb in POOL]  # buffered pre-start
    srv.start()
    srv.shutdown(drain=drain)
    if drain:  # must complete everything queued
        assert all(f.done() for f in futs)
        assert all(f.result() for f in futs)
    else:  # none may be left hanging
        assert all(f.cancelled() or f.done() for f in futs)


def test_closed_server_rejects_submissions():
    srv = ProxyServer(_session()).start()
    srv.shutdown()
    with pytest.raises(ServerClosed):
        srv.submit_evaluate(POOL[0])
    srv.shutdown()  # idempotent


def test_percentile_is_nearest_rank():
    vals = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0]
    assert percentile(vals, 50) == 5.0
    assert percentile(vals, 95) == 10.0
    assert percentile(vals, 99) == 10.0
    assert percentile(vals, 100) == 10.0
    assert percentile([7.5], 99) == 7.5
    assert percentile([], 50) == 0.0
    # a reported percentile is always an observed sample
    assert all(percentile(vals, q) in vals for q in PERCENTILES)


def test_metrics_include_store_counters(tmp_path):
    store = ProxyStore(str(tmp_path))
    _session(store=store).evaluate(POOL[0])
    with ProxyServer(_session(store=store)) as srv:
        srv.submit_evaluate(POOL[0]).result(timeout=300)
    eng = srv.metrics()["engine"]
    assert eng["store_hits"] == 1
    assert eng["compiles"] == 0  # warm-started from the store


def test_request_classes_match_submit_surface():
    """Every request class has a submit_<class> method."""
    for cls in REQUEST_CLASSES:
        assert hasattr(ProxyServer, f"submit_{cls}")


def test_ttfr_is_null_not_nan_without_a_completed_result():
    rec = LatencyRecorder()
    rec.on_submit("tune", 10.0)
    rec.on_submit("evaluate", 11.0)
    rec.on_result("evaluate", 11.0, 11.5)
    rows = rec.summary()
    assert rows["tune"]["ttfr_s"] is None
    assert rows["tune"]["count"] == 0
    assert rows["evaluate"]["ttfr_s"] == 0.5
    text = json.dumps(rows, allow_nan=False)  # strict JSON
    assert json.loads(text)["tune"]["ttfr_s"] is None


def test_latency_window_is_bounded_and_counts_dropped():
    rec = LatencyRecorder(max_samples=4)
    rec.on_submit("evaluate", 0.0)
    for i in range(10):  # latencies 0..9s; ring keeps 6,7,8,9
        rec.on_result("evaluate", 0.0, float(i))
    row = rec.summary()["evaluate"]
    assert row["count"] == 10  # exact over the full stream
    assert row["samples_dropped"] == 6
    assert row["mean_s"] == pytest.approx(7.5)  # retained window only
    assert row["p50_s"] == 7.0  # nearest-rank over [6, 7, 8, 9]
    assert row["p99_s"] == 9.0
    assert row["ttfr_s"] == 0.0  # first result, not the window's first


def test_server_threads_respect_latency_cap():
    with ProxyServer(_session(), max_batch=2,
                     max_latency_samples=3) as srv:
        for _ in range(2):
            for pb in POOL:
                srv.submit_evaluate(pb).result(timeout=300)
        row = srv.metrics()["classes"]["evaluate"]
    assert row["count"] == 2 * len(POOL)
    assert row["samples_dropped"] == 2 * len(POOL) - 3


# ---------------------------------------------------------------------------
# the port held against the reference
# ---------------------------------------------------------------------------

def test_max_batch_defaults_to_the_engine_then_the_constant():
    assert ProxyServer(_session(max_batch=5)).max_batch == 5
    assert ProxyServer(object()).max_batch == DEFAULT_EVAL_BATCH
    assert DEFAULT_EVAL_BATCH == jserver.DEFAULT_EVAL_BATCH
    assert tserver.DEFAULT_LATENCY_SAMPLES == jserver.DEFAULT_LATENCY_SAMPLES


@pytest.mark.parametrize("q", PERCENTILES)
@pytest.mark.parametrize("n", [0, 1, 4097])
def test_percentile_equals_the_reference(n, q):
    vals = sorted(np.random.default_rng(n).exponential(0.01, n).tolist())
    assert percentile(vals, q) == jserver.percentile(vals, q)


def _stream(seed: int):
    """A seeded (class, t_submit, t_done) stream; ``tune`` gets a
    submission and no result."""
    rng = np.random.default_rng(seed)
    subs = np.cumsum(rng.exponential(0.01, 300))
    done = subs + rng.exponential(0.05, 300)
    classes = rng.choice(["evaluate", "signature"], 300)
    return [(str(c), float(s), float(d))
            for c, s, d in zip(classes, subs, done)]


@pytest.mark.parametrize("max_samples", [16, 4096])
def test_latency_recorder_summary_equals_the_reference(max_samples):
    recs = (LatencyRecorder(max_samples), jserver.LatencyRecorder(max_samples))
    for rec in recs:
        rec.on_submit("tune", 0.0)
        for cls, t0, t1 in _stream(max_samples):
            rec.on_submit(cls, t0)
            rec.on_result(cls, t0, t1)
    got, want = (r.summary() for r in recs)
    assert got == want
    assert got["tune"]["ttfr_s"] is None
    dropped = got["evaluate"]["samples_dropped"]
    assert (dropped > 0) == (max_samples < got["evaluate"]["count"])


@pytest.fixture(scope="module")
def jsession():
    """One reference CPU session for every coalescing case (its cache
    makes the later cases cheap)."""
    return JEvalSession(run=False, seed=0)


#: a pre-start burst: evaluates with one signature in the middle, which
#: ends a coalesced batch
BURST = ("evaluate",) * 5 + ("signature",) + ("evaluate",) * 4


@pytest.mark.parametrize("max_batch", [1, 3, 8])
def test_coalescing_equals_the_reference(max_batch, jsession):
    pools = (POOL, [_jpb("sort"), _jpb("logic"),
                    _jpb("sort", data_size=1 << 11), _jpb("statistics")])
    servers = (ProxyServer(_session(), max_batch=max_batch),
               jserver.ProxyServer(jsession, max_batch=max_batch))
    got = []
    for srv, pool in zip(servers, pools):
        futs = [getattr(srv, f"submit_{cls}")(pool[i % len(pool)])
                for i, cls in enumerate(BURST)]
        srv.start()
        for f in futs:
            f.result(timeout=300)
        srv.shutdown()
        m = srv.metrics()
        assert m["errors"] == 0 and m["requests"] == len(BURST)
        got.append(m["batches"])
    assert got[0] == got[1]


def _doc_rows(doc: str, heading: str, prefix: str = ""):
    """First-cell names (backticked) of the table under ``heading``."""
    text = (DOCS / doc).read_text()
    section = text[text.index(heading):]
    section = section[:section.find("\n## ", 1)]
    return [m.group(1) for m in re.finditer(r"^\|\s*`([\w.]+)`", section,
                                            re.M)
            if m.group(1).startswith(prefix)]


def test_classes_and_percentiles_equal_the_reference_and_the_docs():
    assert REQUEST_CLASSES == jserver.REQUEST_CLASSES
    assert PERCENTILES == jserver.PERCENTILES
    assert tuple(_doc_rows("SERVING.md",
                           "## The request-class table")) == REQUEST_CLASSES
    assert f"`PERCENTILES` is `{PERCENTILES}`" in (
        DOCS / "SERVING.md").read_text()


class _Rec:
    """One hub record (the hub keeps tuples) with named fields."""

    def __init__(self, rec):
        (self.name, self.t0, self.t1, _, self.span_id, self.parent_id,
         self.attrs, _) = rec


def _traced_run(hub=None):
    """One of each request class plus a coalesced pair, through a live
    hub; returns (server, the hub's span records by id)."""
    hub = hub or Telemetry()
    srv = ProxyServer(_session(telemetry=hub), max_batch=8)
    futs = [srv.submit_evaluate(POOL[0]), srv.submit_evaluate(POOL[1])]
    srv.start()
    for f in futs:
        f.result(timeout=300)
    srv.submit_signature(POOL[2]).result(timeout=300)
    srv.submit_tune(_tiny_workload, torch.arange(64.0).flip(0), name="w",
                    max_iters=1).result(timeout=600)
    srv.submit_evaluate(POOL[3]).result(timeout=300)
    srv.shutdown()
    return srv, {r.span_id: r for r in map(_Rec, hub._records)}


def test_traced_request_children_sum_to_its_latency():
    srv, recs = _traced_run()
    requests = [r for r in recs.values() if r.name == "serve.request"]
    assert len(requests) == 5
    kids = {}
    for r in recs.values():
        if r.name in ("serve.queue_wait", "serve.batch_assembly",
                      "serve.service"):
            kids.setdefault(r.parent_id, []).append(r)
    rows = srv.metrics()["classes"]
    for req in requests:
        q, a, s = sorted(kids[req.span_id], key=lambda r: r.t0)
        assert [q.name, a.name, s.name] == [
            "serve.queue_wait", "serve.batch_assembly", "serve.service"]
        # the children chain the parent's own timestamps, exactly
        assert (q.t0, q.t1, a.t1, s.t1) == (req.t0, a.t0, s.t0, req.t1)
        assert sum(k.t1 - k.t0 for k in (q, a, s)) == pytest.approx(
            req.t1 - req.t0, rel=0, abs=1e-12)
        if req.attrs["cls"] in ("signature", "tune"):  # one request each
            assert req.t1 - req.t0 == rows[req.attrs["cls"]]["p50_s"]
    batched = [r for r in requests if "batch" in r.attrs]
    assert len(batched) == 2
    batch = recs[batched[0].attrs["batch"]]
    assert batch.name == "serve.batch" and batch.attrs == {"size": 2}


def test_serve_span_names_equal_the_docs():
    _, recs = _traced_run()
    emitted = {r.name for r in recs.values() if r.name.startswith("serve.")}
    documented = _doc_rows("OBSERVABILITY.md", "## The span-kind table",
                           "serve.")
    assert emitted == set(documented)
    from repro_torch.runtime import SPAN_KINDS

    assert tuple(documented) == tuple(k for k in SPAN_KINDS
                                      if k.startswith("serve."))
