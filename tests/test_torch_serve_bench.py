"""The port's serving bench (``repro_torch.bench.serve_bench``) and trace
summary (``repro_torch.bench.trace_summary``) against the reference's
(``benchmarks/serve_bench.py``, ``scripts/trace_summary.py``): the quick
gated run on the CPU, the reference document's keys, the fresh-process
warm start that imports only the port, CUDA by default, and the same
summary and verdict on the same traces.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.runtime import proxy_server as jserver
from repro_torch.bench import serve_bench, trace_summary

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def quick_run(tmp_path_factory):
    """One ``--quick --check --trace`` run with a store, on the CPU."""
    d = tmp_path_factory.mktemp("serve")
    out, trace = d / "serve_bench.json", d / "trace.json"
    rc = serve_bench.main(["--quick", "--check", "--store", str(d / "store"),
                           "--trace", str(trace), "--device", "cpu",
                           "--out", str(out)])
    return rc, json.loads(out.read_text()), trace


def test_quick_check_exits_zero(quick_run):
    rc, doc, _ = quick_run
    assert doc["check"]["failures"] == []
    assert rc == 0
    assert doc["backend"] == "cpu" and doc["config"]["substrate"] == "torch"
    assert doc["parity"]["mismatches"] == 0 and doc["parity"]["checked"] > 0
    assert doc["warm"]["errors"] == 0
    assert doc["tune"]["classes"]["tune"]["count"] == 1


def test_the_probe_warm_starts_on_the_port_alone(quick_run):
    _, doc, _ = quick_run
    probe = doc["warm_start_probe"]
    assert probe["compiles"] == 0
    assert probe["store_hits"] == probe["classes"] == 4
    assert probe["store_invalid"] == 0
    assert probe["modules"] == []  # neither jax nor repro was imported


def _reference_doc_keys():
    """The reference bench's document keys, read from its source: the
    top-level keys in assignment order and each literal block's keys
    (``{k: probe[k] for k in (...)}`` included), plus an open-loop row."""
    tree = ast.parse((ROOT / "benchmarks" / "serve_bench.py").read_text())
    keys = {"": []}

    def literal(node):
        if isinstance(node, ast.Dict):
            return [k.value for k in node.keys]
        if isinstance(node, ast.DictComp):
            return [e.value for e in node.generators[0].iter.elts]
        return None

    def nested(prefix, node):
        for k, v in zip(node.keys, node.values):
            if isinstance(v, ast.Dict) and k.value != "config":
                keys[f"{prefix}.{k.value}"] = literal(v)
                nested(f"{prefix}.{k.value}", v)

    row = []
    in_order = sorted((n for n in ast.walk(tree) if hasattr(n, "lineno")),
                      key=lambda n: (n.lineno, n.col_offset))
    for node in in_order:
        if isinstance(node, ast.AnnAssign) and getattr(
                node.target, "id", "") == "doc":
            keys[""] += literal(node.value)
            keys["config"] = literal(node.value.values[
                literal(node.value).index("config")])
        elif isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Subscript):
            tgt = node.targets[0]
            name = getattr(tgt.value, "id", "")
            if name == "doc":
                keys[""].append(tgt.slice.value)
                if literal(node.value) is not None:
                    keys[tgt.slice.value] = literal(node.value)
                    if isinstance(node.value, ast.Dict):
                        nested(tgt.slice.value, node.value)
            elif name == "row":
                row.append(("after", tgt.slice.value))
        elif isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", "") == "row":
            row.append(("literal", literal(node.value)))
    rec = jserver.LatencyRecorder()
    rec.on_submit("evaluate", 0.0)
    rec.on_result("evaluate", 0.0, 1.0)
    row_keys = [k for kind, ks in row if kind == "literal" for k in ks]
    row_keys += list(rec.summary()["evaluate"])
    row_keys += [k for kind, k in row if kind == "after"]
    return keys, tuple(row_keys)


def test_doc_keys_are_the_reference_benchmarks():
    keys, row = _reference_doc_keys()
    assert {k: tuple(v) for k, v in keys.items()} == serve_bench.DOC_KEYS
    assert row == serve_bench.OPEN_LOOP_KEYS


def test_the_document_lacks_no_reference_key(quick_run):
    _, doc, _ = quick_run
    assert serve_bench.missing_keys(doc) == []
    assert set(serve_bench.DOC_KEYS[""]) <= set(doc)
    short = dict(doc, warm={k: v for k, v in doc["warm"].items()
                            if k != "errors"})
    del short["parity"]
    short["open_loop"] = [{"rate_rps": 8.0}]
    missing = serve_bench.missing_keys(short)
    assert missing[:2] == ["parity", "warm.errors"]
    assert "open_loop[0].p99_s" in missing


def test_the_pool_keeps_the_reference_classes():
    from benchmarks import serve_bench as jbench

    assert serve_bench.POOL_SPECS == jbench.POOL_SPECS
    pool = serve_bench.build_pool(False, "hopper")
    assert [(pb.nodes[0].motif, pb.nodes[0].p.data_size) for pb in pool] \
        == list(jbench.POOL_SPECS)
    assert {pb.nodes[0].p.substrate for pb in pool} == {"hopper"}
    assert len(serve_bench.build_pool(True)) == 4


def test_the_bench_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_bench.main([])


def _cut_short(trace: Path, out: Path) -> Path:
    """``trace`` with the longest request service segment (the tune's)
    10 ms short."""
    doc = json.loads(trace.read_text())
    svc = max((e for e in doc["traceEvents"]
               if e.get("name") == "serve.service"), key=lambda e: e["dur"])
    assert svc["dur"] > 1e4
    svc["dur"] -= 1e4
    out.write_text(json.dumps(doc))
    return out


@pytest.fixture(scope="module")
def served_trace(tmp_path_factory):
    """A trace that holds every span kind ``trace_summary --check``
    requires: a traced server whose pre-start burst coalesces (a
    ``serve.batch``), then a tune (the longest service segment)."""
    from repro_torch.core import EvalSession
    from repro_torch.runtime import ProxyServer, Telemetry

    hub = Telemetry()
    srv = ProxyServer(EvalSession(run=False, seed=0, device="cpu",
                                  telemetry=hub))
    pool = serve_bench.build_pool(True)
    futs = [srv.submit_evaluate(pb) for pb in pool]
    srv.start()
    for f in futs:
        f.result(timeout=300)
    srv.submit_tune(serve_bench._tiny_workload, torch.arange(64.0).flip(0),
                    name="t", max_iters=1).result(timeout=600)
    srv.shutdown()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    hub.export_trace(str(path))
    return path


@pytest.mark.parametrize("variant", ["good", "cut_short"])
def test_trace_summary_equals_the_reference_script(served_trace, tmp_path,
                                                   variant):
    trace = served_trace
    if variant == "cut_short":
        trace = _cut_short(trace, tmp_path / "cut.json")
    want_out, got_out = tmp_path / "want.json", tmp_path / "got.json"
    ref = subprocess.run(
        [sys.executable, "scripts/trace_summary.py", str(trace), "--check",
         "--out", str(want_out)], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    rc = trace_summary.main([str(trace), "--check", "--out", str(got_out)])
    assert rc == ref.returncode == (0 if variant == "good" else 1)
    got, want = json.loads(got_out.read_text()), json.loads(
        want_out.read_text())
    assert got == want
    assert bool(got["check"]["failures"]) == (variant == "cut_short")
