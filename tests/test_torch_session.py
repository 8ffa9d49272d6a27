"""The port's ``EvalSession`` and ``serial_evaluate_batch``
(``repro_torch.core.evaluator``) against the reference's.

The cache keys are structural and equal in both packages, so the same
sequence of candidates under the same workload scopes gives the same
cache traffic — hits, misses, compiles, evictions, cross-workload hits
— in both sessions, workload by workload.
"""
import dataclasses
import json

import pytest

from repro.core import EvalSession as JEvalSession
from repro.core.motifs import PVector as JPVector
from repro.core.proxy_graph import MotifNode as JMotifNode
from repro.core.proxy_graph import ProxyBenchmark as JProxyBenchmark
from repro_torch.core import (BatchEvaluator, EvalSession, generate_proxy,
                              serial_evaluate_batch)
from repro_torch.core.motifs import PVector, motif_names
from repro_torch.core.proxy_graph import MotifNode, ProxyBenchmark
from repro_torch.workloads import WORKLOADS

P = dict(data_size=1 << 10, chunk_size=1 << 6, num_tasks=2, batch_size=2,
         height=8, width=8, channels=4)
#: the counters both packages' stats hold
COUNTERS = ("hits", "misses", "compiles", "evictions", "cross_workload_hits",
            "evals")


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


#: (workload scope, candidates) of a two-workload sweep: the second
#: revisits two of the first's classes and adds one
SWEEP = (("a", (("sort", {}), ("statistics", {}), ("sort", {"weight": 1.2}),
                ("statistics", {"sparsity": 0.5}))),
         ("b", (("statistics", {}), ("sort", {"data_size": 2048}),
                ("sort", {}))))


def _sweep(session, make):
    for name, cands in SWEEP:
        with session.workload(name):
            session.evaluate_batch([make(m, **u) for m, u in cands])
    return session


def test_scoped_traffic_equals_the_reference():
    got = _sweep(EvalSession(run=False, seed=0, device="cpu", capacity=4), _pb)
    want = _sweep(JEvalSession(run=False, seed=0, capacity=4), _jpb)
    assert {k: got.stats()[k] for k in COUNTERS} == {
        k: want.stats()[k] for k in COUNTERS}
    for name in ("a", "b"):
        assert {k: got.workload_stats[name][k] for k in COUNTERS} == {
            k: want.workload_stats[name][k] for k in COUNTERS}
    assert got.cross_workload_hits == want.cross_workload_hits == 2


def test_workload_stats_sum_to_the_session_and_drop_gauges():
    s = _sweep(EvalSession(run=False, seed=0, device="cpu"), _pb)
    assert list(s.workload_stats) == ["a", "b"]
    for k, v in s.stats().items():
        if k == "entries":
            assert all(k not in d for d in s.workload_stats.values())
        else:
            assert sum(d[k] for d in s.workload_stats.values()) == v, k
    assert s.workload_stats["b"]["cross_workload_hits"] == 2
    assert s.workload_stats["a"]["cross_workload_hits"] == 0
    # a re-entered scope accumulates
    assert (s.workload_stats["a"]["hits"], s.workload_stats["a"]["evals"]) \
        == (0, 4)
    with s.workload("a"):
        s.evaluate(_pb("sort"))
    assert (s.workload_stats["a"]["hits"], s.workload_stats["a"]["evals"]) \
        == (1, 5)


def test_a_nested_scope_raises_and_clears():
    s = EvalSession(run=False, device="cpu")
    with s.workload("a"):
        with pytest.raises(RuntimeError, match="already active"):
            with s.workload("b"):
                pass
    with s.workload("b"):  # the failed entry left no scope behind
        s.evaluate(_pb())
    assert list(s.workload_stats) == ["a", "b"]


def test_session_delegates_the_evaluator_protocol():
    s = EvalSession(run=False, seed=3, device="cpu", wall_iters=2)
    assert (s.run, s.seed, s.device.type, s.substrate) == (False, 3, "cpu",
                                                           "torch")
    s.metrics = ["mix_sort"]
    assert s.engine.metrics == ["mix_sort"]
    assert s(_pb()) == s.evaluate(_pb()) == {"mix_sort": s.evaluate(
        _pb())["mix_sort"]}
    assert s.evals == 3
    with pytest.raises(ValueError, match="unknown substrate"):
        EvalSession(device="cpu", substrate="pallas")


def _pool():
    """One candidate per motif, plus lifted-knob variants that share a
    class."""
    pool = [_pb(m) for m in motif_names()]
    pool += [_pb("sort", sparsity=0.5), _pb("matrix", dist_scale=2.0),
             _pb("sort", weight=2.0)]
    return pool


def test_serial_lifted_equals_the_batched_engine_for_every_motif():
    pool = _pool()
    ev = BatchEvaluator(run=False, seed=0, device="cpu")
    assert serial_evaluate_batch(pool, run=False, lifted=True,
                                 device="cpu") == ev.evaluate_batch(pool)
    assert ev.stats()["compiles"] == len(pool) - 2  # two share a class
    names = ["mix_sort", "arith_intensity"]
    assert serial_evaluate_batch(pool[:2], run=False, lifted=True,
                                 metrics=names, device="cpu") == [
        {k: m[k] for k in names} for m in ev.evaluate_batch(pool[:2])]


def test_serial_static_form_profiles_the_baked_program():
    pool = [_pb("sort"), _pb("statistics", sparsity=0.5)]
    static = serial_evaluate_batch(pool, run=False, device="cpu")
    lifted = serial_evaluate_batch(pool, run=False, lifted=True,
                                   device="cpu")
    for s, m in zip(static, lifted):
        assert set(s) == set(m) and s["arith_intensity"] > 0
    timed = serial_evaluate_batch(pool[:1], run=True, device="cpu")[0]
    assert timed["flops_rate"] >= 0 and "bytes_rate" in timed


def _kmeans(**kw):
    w = WORKLOADS["kmeans"]
    args = w.inputs(seed=0, scale=0.005, device="cpu")
    kw.setdefault("name", "km")
    return generate_proxy(
        w.step, *args, hints=w.hints,
        base_p=PVector(data_size=2 ** 11, chunk_size=64, num_tasks=2),
        max_iters=2, run=False, device="cpu", **kw)


def _same_report(a, b):
    for f in ("qualified", "mean_accuracy", "per_metric_accuracy",
              "iterations", "evals", "tree_depth", "target_metrics",
              "proxy_metrics", "trace", "prior_seeded"):
        assert getattr(a, f) == getattr(b, f), f


def test_generate_proxy_through_a_session_equals_an_evaluator():
    pb_e, rep_e = _kmeans(evaluator=BatchEvaluator(run=False,
                                                   device="cpu"))
    session = EvalSession(run=False, device="cpu")
    pb_s, rep_s = _kmeans(session=session)
    _same_report(rep_s, rep_e)
    assert pb_s.to_json() == pb_e.to_json()
    assert rep_s.engine_stats == rep_e.engine_stats
    assert dict(session.workload_stats["km"]) == dict(rep_s.engine_stats)


def test_a_session_sweep_warm_starts_the_second_workload():
    session = EvalSession(run=False, device="cpu")
    _, first = _kmeans(session=session, name="first")
    _, second = _kmeans(session=session, name="second")
    _same_report(second, first)
    assert first.engine_stats["compiles"] > 0
    assert second.engine_stats["compiles"] == 0
    assert second.engine_stats["cross_workload_hits"] > 0
    assert session.cross_workload_hits == second.engine_stats[
        "cross_workload_hits"]
    assert sum(d["compiles"] for d in session.workload_stats.values()) == \
        session.stats()["compiles"]


def test_generate_proxy_inherits_the_session_substrate():
    session = EvalSession(run=False, device="cpu", substrate="hopper")
    pb, _ = _kmeans(session=session)
    assert {n.p.substrate for n in pb.nodes} == {"hopper"}
    pb, _ = _kmeans(session=session, substrate="torch", name="stock")
    assert {n.p.substrate for n in pb.nodes} == {"torch"}


@pytest.mark.parametrize("kw,match", [
    (dict(session=EvalSession(run=False, device="cpu"),
          evaluator=BatchEvaluator(run=False, device="cpu")), "not both"),
    (dict(session=EvalSession(run=True, device="cpu")), "run=True"),
    (dict(session=EvalSession(run=False, seed=1, device="cpu")), "seed=1"),
])
def test_generate_proxy_refuses_a_mismatched_engine(kw, match):
    with pytest.raises(ValueError, match=match):
        _kmeans(**kw)


def test_session_stats_keys_are_the_reference_counters_and_store_keys(
        tmp_path):
    from repro_torch.core import ProxyStore

    s = EvalSession(run=False, device="cpu",
                    store=ProxyStore(str(tmp_path)))
    s.evaluate(_pb())
    want = set(JEvalSession(run=False).stats()) - {
        "pop_hits", "pop_builds", "pop_entries", "compile_workers_max"}
    assert set(s.stats()) == want | set(s.store.stats())
    json.dumps(dataclasses.asdict(s.signature_of(_pb())))
