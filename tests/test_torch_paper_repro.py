"""The port's paper-reproduction benchmark (``repro_torch.bench.paper_repro``)
against the reference's (``benchmarks/paper_repro.py``): the same
per-workload ``BASE_P``, the same JSON keys at every level, ``--store``
warm starts, and CUDA by default.
"""
import dataclasses
import json
import re

import pytest
import torch

from benchmarks import paper_repro as jrepro
from repro_torch.bench import paper_repro as trepro
from repro_torch.core.motifs import PVector

SUB = {"xla": "torch", "pallas": "hopper"}
SMALL = ["--device", "cpu", "--workload", "kmeans", "--scale", "0.005"]


def _run(tmp_path, name, *extra):
    out = tmp_path / f"{name}.json"
    assert trepro.main(SMALL + ["--out", str(out), *extra]) == 0
    return json.loads(out.read_text()), out


def test_base_p_equals_the_reference_field_for_field():
    assert set(trepro.BASE_P) == set(jrepro.BASE_P)
    for name, want in jrepro.BASE_P.items():
        want = dataclasses.asdict(want)
        want["substrate"] = SUB[want["substrate"]]
        assert dataclasses.asdict(trepro.BASE_P[name]) == want, name
        assert isinstance(trepro.BASE_P[name], PVector)


def test_the_key_lists_are_the_reference_docstrings():
    doc = jrepro.__doc__
    record = doc[doc.index('{"workload"'):doc.index('"session"')]
    session = doc[doc.index('"session"'):]
    assert re.findall(r'"(\w+)":', record) == list(trepro.RECORD_KEYS)
    assert re.findall(r'"(\w+)":', session) == ["session"] + list(
        trepro.SESSION_KEYS)
    engine = re.search(r'"engine_stats": \{([^}]*)\}', doc).group(1)
    assert [k.strip() for k in engine.split(",")][:-1] == list(
        trepro.ENGINE_KEYS)
    stats = re.search(r'"stats": \{([^}]*)\}', doc).group(1)
    assert [k.strip() for k in stats.split(",")][:-1] == list(
        trepro.SESSION_STATS_KEYS)


def test_main_writes_the_reference_keys(tmp_path, capsys):
    doc, out = _run(tmp_path, "shared", "--iters", "2")
    assert trepro.missing_keys(doc) == []
    (rec,) = doc["workloads"]
    assert set(rec) == set(trepro.RECORD_KEYS + trepro.EXTRA_RECORD_KEYS)
    assert rec["workload"] == "kmeans" and rec["scale"] == 0.005
    assert rec["iterations"] <= 2 and len(rec["trace"]) == rec["iterations"]
    assert 0.0 <= rec["mean_accuracy"] <= 1.0
    assert rec["real_wall_time_s"] > 0 and rec["proxy_wall_time_s"] > 0
    assert set(rec["per_metric_accuracy"]) == set(rec["target_metrics"])
    assert json.loads(rec["proxy_json"])["name"] == "kmeans"
    assert doc["session"]["per_workload"]["kmeans"]["compiles"] == \
        doc["session"]["stats"]["compiles"] == rec["engine_stats"]["compiles"]
    assert sorted(p.name for p in out.parent.iterdir()) == [out.name]
    printed = capsys.readouterr().out
    assert "paper reproduction summary" in printed
    assert "shared session:" in printed


def test_no_share_has_no_session_block(tmp_path):
    doc, _ = _run(tmp_path, "alone", "--iters", "1", "--no-share")
    assert "session" not in doc
    assert trepro.missing_keys(doc, shared=False) == []
    assert trepro.missing_keys(doc) == [
        "session.stats", "session.per_workload",
        "session.total_tuning_wall_s", "session.stats.hits",
        "session.stats.misses", "session.stats.compiles",
        "session.stats.cross_workload_hits"]


def test_store_warm_starts_a_second_call(tmp_path):
    """``--iters 0`` tunes the impact batch alone, which profiles the same
    classes on every run (later moves steer on measured rates, which vary
    between runs on a host)."""
    store = str(tmp_path / "store")
    cold, _ = _run(tmp_path, "cold", "--iters", "0", "--store", store)
    warm, _ = _run(tmp_path, "warm", "--iters", "0", "--store", store)
    c, w = cold["session"]["stats"], warm["session"]["stats"]
    assert c["compiles"] > 0 and c["store_saves"] == c["compiles"]
    assert w["compiles"] == 0 and w["store_hits"] == c["compiles"]
    assert w["store_invalid"] == 0
    assert warm["workloads"][0]["engine_stats"]["compiles"] == 0


def test_the_benchmark_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trepro.main([])


@pytest.mark.parametrize("share", [[], ["--no-share"]])
def test_substrate_flag_puts_every_proxy_node_on_it(tmp_path, capsys,
                                                    share):
    doc, _ = _run(tmp_path, "hopper", "--iters", "0", "--substrate",
                  "hopper", *share)
    (rec,) = doc["workloads"]
    nodes = json.loads(rec["proxy_json"])["nodes"]
    assert nodes and {n["p"]["substrate"] for n in nodes} == {"hopper"}
    assert rec["real_timing"]["mode"] == rec["proxy_timing"]["mode"] == \
        "eager"
    assert "eager/eager" in capsys.readouterr().out
