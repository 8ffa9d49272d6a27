"""The port's mesh-shape arithmetic (``repro_torch.core.cluster``, the rule
table of ``repro_torch.distributed.sharding``) and the tuner's quantize
hook against the reference's, on the same inputs.

The quanta read a mesh only through its axis names and sizes, so the
reference's mesh stand-ins (``conftest.QuantumMesh``/``GridMesh``) serve
both packages, and so does the port's ``MeshShape``.  Quantization and
trend scores must be equal; the quantize-hooked tuners, on the same
analytic evaluator, must submit the same candidates and report the same
``qualification_rate``.
"""
import math

import numpy as np
import pytest
from _prop import given, settings, strategies as st

from conftest import GridMesh, QuantumMesh

from repro.core import cluster as jcluster
from repro.core.motifs import PVector as JPVector
from repro.core.proxy_graph import MotifNode as JMotifNode
from repro.core.proxy_graph import ProxyBenchmark as JProxyBenchmark
from repro.core.tuner import DecisionTreeTuner as JTuner
from repro.distributed import sharding as jsharding
from repro_torch.core import cluster as tcluster
from repro_torch.core.motifs import PVector
from repro_torch.core.proxy_graph import MotifNode, ProxyBenchmark
from repro_torch.core.tuner import DecisionTreeTuner, encode, movable_params
from repro_torch.distributed import sharding as tsharding
from repro_torch.distributed.sharding import MeshShape

P = dict(data_size=1 << 10, chunk_size=1 << 6, num_tasks=2, batch_size=2,
         height=8, width=8, channels=4)

#: mesh stand-ins both packages read: 1-D, 2-D, pod x data, swapped axes
MESHES = {"q4": QuantumMesh(4), "q3": QuantumMesh(3),
          "d2m3": GridMesh({"data": 2, "model": 3}),
          "m2d2": GridMesh({"model": 2, "data": 2}),
          "p2d3": GridMesh({"pod": 2, "data": 3}),
          "d1m2": GridMesh({"data": 1, "model": 2}), "none": None}


def _pb(**updates) -> ProxyBenchmark:
    return ProxyBenchmark("t", (MotifNode("n0", "sort", "",
                                          PVector(**P).replace(**updates)),))


def _jpb(**updates) -> JProxyBenchmark:
    return JProxyBenchmark("t", (JMotifNode(
        "n0", "sort", "", JPVector(**P).replace(**updates)),))


# -- the rule table ----------------------------------------------------------


def test_rule_table_is_the_reference():
    assert tsharding.DEFAULT_RULES == jsharding.DEFAULT_RULES
    t, j = tsharding.ShardingRules(), jsharding.ShardingRules()
    assert t.structural_key() == j.structural_key()
    over = {"batch": "data", "mlp": None}
    assert (t.with_overrides(over).structural_key()
            == j.with_overrides(over).structural_key())


@pytest.mark.parametrize("mesh", [m for k, m in MESHES.items()
                                  if m is not None], ids=lambda m: str(
                                      getattr(m, "shape", m)))
def test_mesh_axes_for_equals_the_reference(mesh):
    t, j = tsharding.ShardingRules(), jsharding.ShardingRules()
    for logical in list(tsharding.DEFAULT_RULES) + [None, "no_such_axis"]:
        assert t.mesh_axes_for(logical, mesh) == j.mesh_axes_for(
            logical, mesh), logical


def test_mesh_shape_and_a_device_mesh_read_alike():
    shape = MeshShape(("data", "model"), (2, 3))
    assert tsharding.mesh_axes(shape) == (("data", 2), ("model", 3))
    assert tsharding.mesh_axes(GridMesh({"data": 2, "model": 3})) == \
        tsharding.mesh_axes(shape)

    class DeviceMeshLike:  # torch.distributed.device_mesh.DeviceMesh's API
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return (2, 3)[i]

    assert tsharding.mesh_axes(DeviceMeshLike()) == tsharding.mesh_axes(shape)
    assert tcluster.batch_quantum(DeviceMeshLike()) == 2
    assert tcluster.mesh_structural_key(DeviceMeshLike()) == \
        jcluster.mesh_structural_key(GridMesh({"data": 2, "model": 3}))


# -- quanta, keys and quantization -----------------------------------------------


@pytest.mark.parametrize("name", sorted(MESHES))
def test_quanta_and_structural_key_equal_the_reference(name):
    mesh = MESHES[name]
    for fn in ("batch_quantum", "model_quantum", "mesh_task_quantum",
               "mesh_structural_key"):
        assert getattr(tcluster, fn)(mesh) == getattr(jcluster, fn)(mesh), fn
    for logical in ("batch", "motif_width", "heads", "no_such_axis"):
        assert tcluster.axis_quantum(mesh, logical) == \
            jcluster.axis_quantum(mesh, logical), logical


def test_structural_key_tells_flat_from_grid_and_swapped_axes():
    key = tcluster.mesh_structural_key
    assert key(QuantumMesh(4)) != key(GridMesh({"data": 2, "model": 2}))
    assert key(GridMesh({"data": 2, "model": 2})) != \
        key(GridMesh({"model": 2, "data": 2}))
    assert key(None) is None


def test_quantize_identity_without_a_splitting_mesh():
    pb = _pb(data_size=1001)
    assert tcluster.quantize_proxy(pb, None) is pb
    assert tcluster.quantize_proxy(pb, GridMesh({"model": 4})) is pb
    assert tcluster.make_quantizer(None) is None
    assert tcluster.make_quantizer(QuantumMesh(1)) is None
    assert tcluster.make_quantizer(QuantumMesh(4)) is not None
    assert tcluster.QUANTIZED_FIELDS == jcluster.QUANTIZED_FIELDS


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("sizes", [(1001, 3), (1024, 2), (7, 1), (1 << 13,
                                                                   63)])
def test_quantize_proxy_equals_the_reference(name, sizes):
    mesh = MESHES[name]
    data_size, batch_size = sizes
    q = tcluster.quantize_proxy(_pb(data_size=data_size,
                                    batch_size=batch_size), mesh)
    jq = jcluster.quantize_proxy(_jpb(data_size=data_size,
                                      batch_size=batch_size), mesh)
    assert q.shape_signature() == jq.shape_signature()
    assert tcluster.quantize_proxy(q, mesh) is q


@given(st.sampled_from(("1d", "2d", "pod2d")),
       st.integers(min_value=1, max_value=8),
       st.integers(min_value=1, max_value=8),
       st.integers(min_value=1, max_value=1 << 14),
       st.integers(min_value=1, max_value=64))
@settings(max_examples=40, deadline=None)
def test_quantize_prop_equals_the_reference(kind, d, m, data_size,
                                            batch_size):
    mesh = {"1d": GridMesh({"data": d}),
            "2d": GridMesh({"data": d, "model": m}),
            "pod2d": GridMesh({"pod": d, "data": m})}[kind]
    q = tcluster.batch_quantum(mesh)
    assert q == jcluster.batch_quantum(mesh)
    qq = tcluster.quantize_proxy(_pb(data_size=data_size,
                                     batch_size=batch_size), mesh)
    p = qq.node("n0").p
    assert p.data_size % q == 0 and data_size <= p.data_size < data_size + q
    assert p.batch_size % q == 0 and batch_size <= p.batch_size \
        < batch_size + q
    jp = jcluster.quantize_proxy(_jpb(data_size=data_size,
                                      batch_size=batch_size), mesh)
    assert (p.data_size, p.batch_size) == (jp.node("n0").p.data_size,
                                           jp.node("n0").p.batch_size)
    assert tcluster.quantize_proxy(qq, mesh) is qq


# -- trend consistency -------------------------------------------------------


TRENDS = {
    "perfect": ({"s1": {"m": 1.0, "k": 4.0}, "s2": {"m": 2.0, "k": 3.0},
                 "s3": {"m": 3.0, "k": 2.0}},
                {"s1": {"m": 10.0, "k": 8.0}, "s2": {"m": 20.0, "k": 6.0},
                 "s3": {"m": 30.0, "k": 4.0}}),
    "inverted": ({"s1": {"m": 1.0}, "s2": {"m": 2.0}, "s3": {"m": 3.0}},
                 {"s1": {"m": 3.0}, "s2": {"m": 2.0}, "s3": {"m": 1.0}}),
    "flat_proxy": ({"s1": {"m": 1.0}, "s2": {"m": 2.0}, "s3": {"m": 3.0}},
                   {"s1": {"m": 5.0}, "s2": {"m": 5.0}, "s3": {"m": 5.0}}),
    "both_flat": ({"s1": {"m": 5.0}, "s2": {"m": 5.0}, "s3": {"m": 5.0}},
                  {"s1": {"m": 5.0}, "s2": {"m": 5.0}, "s3": {"m": 5.0}}),
    "within_eps": ({"s1": {"m": 1.0}, "s2": {"m": 1.001}},
                   {"s1": {"m": 1.0}, "s2": {"m": 2.0}}),
    "ties": ({"s1": {"m": 1.0}, "s2": {"m": 1.0}, "s3": {"m": 2.0}},
             {"s1": {"m": 5.0}, "s2": {"m": 5.0}, "s3": {"m": 9.0}}),
    "broken_tie": ({"dp2": {"m": 1.0}, "dp4": {"m": 2.0},
                    "dp2_mp2": {"m": 2.0}},
                   {"dp2": {"m": 10.0}, "dp4": {"m": 30.0},
                    "dp2_mp2": {"m": 5.0}}),
}


@pytest.mark.parametrize("case", sorted(TRENDS))
def test_trend_consistency_equals_the_reference(case):
    real, proxy = TRENDS[case]
    got = tcluster.trend_consistency(real, proxy)
    want = jcluster.trend_consistency(real, proxy)
    assert got == want


def test_trend_consistency_errors():
    with pytest.raises(tcluster.ClusterError):
        tcluster.trend_consistency({"s1": {"m": 1.0}}, {"s1": {"m": 1.0}})
    with pytest.raises(tcluster.ClusterError):
        tcluster.trend_consistency({"s1": {"a": 1.0}, "s2": {"a": 2.0}},
                                   {"s1": {"b": 1.0}, "s2": {"b": 2.0}})


@pytest.mark.parametrize("vals", [
    ([1.0, 1.0, 2.0], [1.0, 2.0, 2.0]), ([3.0, 1.0, 3.0, 3.0], None),
    ([1.0, 1.0, 2.0, 3.0], [1.0, 2.0, 2.0, 3.0]),
    ([2.0, 2.0, 2.0], [1.0, 2.0, 3.0]), ([2.0, 2.0], [2.0, 2.0])])
def test_ranks_and_spearman_equal_the_reference(vals):
    a = np.asarray(vals[0])
    b = np.asarray(vals[1] if vals[1] is not None else vals[0][::-1])
    assert list(tcluster._avg_ranks(a)) == list(jcluster._avg_ranks(a))
    assert tcluster._spearman(a, b) == jcluster._spearman(a, b)
    assert tcluster._spearman(b, a) == jcluster._spearman(b, a)


# -- the tuner's quantize hook -------------------------------------------------


def _analytic_eval(pb):
    p = pb.node("n0").p
    return {"m_lin": float(p.data_size) * 1e-3,
            "m_mix": float(p.weight) / (p.weight + 2.0)}


def _pair(quantize_t, quantize_j, start_updates, target, **kw):
    """Run both tuners from the same start on the same analytic evaluator;
    returns (result, tuner, submitted P tuples) for each."""
    out = []
    for Tuner, mk, node_cls, q in (
            (DecisionTreeTuner, PVector, MotifNode, quantize_t),
            (JTuner, JPVector, JMotifNode, quantize_j)):
        seen = []

        def recording(pb, seen=seen):
            seen.append(pb.node("n0").p)
            return _analytic_eval(pb)

        Cls = ProxyBenchmark if Tuner is DecisionTreeTuner \
            else JProxyBenchmark
        start = Cls("t", (node_cls("n0", "sort", "quick",
                                   mk(**start_updates)),))
        tuner = Tuner(recording, target, quantize=q, **kw)
        res = tuner.tune(start)
        out.append((res, tuner, [(p.data_size, p.chunk_size, p.num_tasks,
                                  p.weight, p.batch_size) for p in seen]))
    return out


def test_quantized_tuner_submits_the_references_candidates():
    target = {"m_lin": (1 << 15) * 1e-3, "m_mix": 4.0 / 6.0}
    (res, tuner, seen), (jres, jtuner, jseen) = _pair(
        tcluster.make_quantizer(QuantumMesh(4)),
        jcluster.make_quantizer(QuantumMesh(4)),
        {"data_size": (1 << 12) + 3}, target, tol=0.1, max_iters=20)
    assert seen == jseen and seen
    assert res.qualification_rate == jres.qualification_rate == 1.0
    assert tuner.submitted == jtuner.submitted == len(seen)
    for data_size, _, _, _, batch_size in seen:
        assert data_size % 4 == 0 and batch_size % 4 == 0


def test_identity_quantize_is_bit_identical_to_no_quantize():
    start = ProxyBenchmark("t", (MotifNode("n0", "sort", "quick",
                                           PVector(data_size=1 << 12)),))
    target = {"m_lin": (1 << 15) * 1e-3, "m_mix": 4.0 / 6.0}
    r1 = DecisionTreeTuner(_analytic_eval, target, tol=0.1,
                           max_iters=20).tune(start)
    r2 = DecisionTreeTuner(_analytic_eval, target, tol=0.1, max_iters=20,
                           quantize=lambda pb: pb).tune(start)
    assert r1.proxy == r2.proxy
    assert r1.trace == r2.trace
    assert r1.final_devs == r2.final_devs
    assert r1.qualification_rate == r2.qualification_rate == 1.0


def test_quantize_rate_counts_unqualified_submissions_as_the_reference():
    target = {"m_lin": 1.0, "m_mix": 0.5}
    rates = []
    for Tuner, q, Cls, Node, Vec in (
            (DecisionTreeTuner, tcluster.make_quantizer(QuantumMesh(4)),
             ProxyBenchmark, MotifNode, PVector),
            (JTuner, jcluster.make_quantizer(QuantumMesh(4)),
             JProxyBenchmark, JMotifNode, JPVector)):
        tuner = Tuner(_analytic_eval, target, quantize=q)
        odd = Cls("t", (Node("n0", "sort", "quick", Vec(data_size=1001)),))
        tuner._eval_batch([q(odd), odd])  # one qualified, one not
        rates.append((tuner.submitted, tuner.submitted_qualified,
                      tuner.qualification_rate))
    assert rates[0] == rates[1] == (2, 1, 0.5)


def _couple(pb):
    """chunk_size slaved to data_size: every data_size probe also moves
    chunk_size (coupled), every chunk_size probe rounds back."""
    p = pb.node("n0").p
    return pb.with_node("n0", chunk_size=max(p.data_size // 16, 16))


def test_impact_probe_drops_coupled_moves_as_the_reference():
    elasticities = []
    for Tuner, Cls, Node, Vec in (
            (DecisionTreeTuner, ProxyBenchmark, MotifNode, PVector),
            (JTuner, JProxyBenchmark, JMotifNode, JPVector)):
        seen = []

        def recording(pb, seen=seen):
            seen.append(pb)
            return _analytic_eval(pb)

        start = _couple(Cls("t", (Node("n0", "sort", "quick",
                                       Vec(data_size=1 << 12)),)))
        tuner = Tuner(recording, {"m_lin": 1.0, "m_mix": 0.5},
                      quantize=_couple)
        from repro.core.tuner import movable_params as jmovable

        refs = (movable_params if Tuner is DecisionTreeTuner
                else jmovable)(start)
        tuner.impact_analysis(start, refs)
        base = start.node("n0").p
        for pb in seen:
            p = pb.node("n0").p
            assert (p.data_size, p.chunk_size) == (base.data_size,
                                                   base.chunk_size)
        elasticities.append(sorted(tuner.elasticity))
    assert elasticities[0] == elasticities[1]
    assert not any(k[0] == "n0.data_size" for k in elasticities[0])
    assert any(k[0] == "n0.weight" for k in elasticities[0])


def test_explore_never_returns_a_noop_candidate():
    cur = ProxyBenchmark("t", (MotifNode("n0", "sort", "quick",
                                         PVector(data_size=1 << 12)),))

    def pin_data_size(pb):
        return pb.with_node("n0", data_size=1 << 12)

    target = {"m_lin": (1 << 13) * 1e-3, "m_mix": 1.0 / 3.0}
    tuner = DecisionTreeTuner(_analytic_eval, target, tol=0.05,
                              quantize=pin_data_size, seed=3)
    refs = movable_params(pin_data_size(cur))
    for _ in range(50):
        out = tuner._explore(pin_data_size(cur), refs)
        assert out is not None
        cand, label, factor, idx = out
        assert label != "n0.data_size"
        assert not np.array_equal(encode(cand, refs),
                                  encode(pin_data_size(cur), refs))
    exhausted = DecisionTreeTuner(_analytic_eval, target, tol=0.05,
                                  quantize=lambda pb: cur, seed=3)
    assert exhausted._explore(cur, refs) is None


def test_qualification_rate_reaches_the_generator_report_field():
    from repro_torch.core.tuner import TuneResult

    assert TuneResult.__dataclass_fields__["qualification_rate"].default \
        == 1.0
    res = DecisionTreeTuner(_analytic_eval, {"m_lin": 8.0, "m_mix": 0.5},
                            quantize=tcluster.make_quantizer(
                                QuantumMesh(4)), max_iters=3).tune(
        _pb(data_size=1001))
    assert res.qualification_rate == 1.0
    assert res.proxy.node("n0").p.data_size % 4 == 0
    assert math.isfinite(res.mean_accuracy)
