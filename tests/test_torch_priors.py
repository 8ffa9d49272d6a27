"""The port's elasticity priors (``repro_torch.core.priors``) and the
prior-seeded tuner against the reference's.

Priors are pure arithmetic on a decomposition, so the port's table for
the port's decomposition of a signature must equal the reference's for
the reference's, slope for slope.  On deterministic stub evaluators the
prior-seeded tuners must agree move for move.
"""
import dataclasses
import json
import math

import jax
import pytest

from test_torch_pipeline import _mapped_json, _ref_chain, _stub_metrics

from repro.core import priors as jpriors
from repro.core.accuracy import normalized_vector as jnormalized
from repro.core.decompose import decompose as jdecompose
from repro.core.generator import select_metrics as jselect_metrics
from repro.core.motifs import PVector as JPVector
from repro.core.proxy_graph import MotifNode as JMotifNode
from repro.core.proxy_graph import ProxyBenchmark as JProxyBenchmark
from repro.core.signature import signature_of_jitted
from repro.core.tuner import DecisionTreeTuner as JTuner
from repro.workloads import WORKLOADS as JWORKLOADS
from repro_torch.convert import (proxy_from_reference_json,
                                 signature_from_reference)
from repro_torch.core import EvalSession, generate_proxy
from repro_torch.core import priors as tpriors
from repro_torch.core.accuracy import normalized_vector
from repro_torch.core.decompose import decompose
from repro_torch.core.generator import select_metrics
from repro_torch.core.motifs import PVector
from repro_torch.core.proxy_graph import MotifNode, ProxyBenchmark
from repro_torch.core.tuner import DecisionTreeTuner
from repro_torch.workloads import WORKLOADS


@pytest.fixture(scope="module")
def ref_kmeans_signature():
    w = JWORKLOADS["kmeans"]
    args = w.inputs(jax.random.key(0), scale=0.02)
    return signature_of_jitted(w.step, *args, run=False)


@pytest.mark.parametrize("base_p", [None, dict(data_size=1 << 14,
                                               chunk_size=64, num_tasks=8,
                                               batch_size=32,
                                               distribution="normal",
                                               sparsity=0.9)])
def test_kmeans_priors_equal_the_reference(ref_kmeans_signature, base_p):
    hints = JWORKLOADS["kmeans"].hints
    jpb = jdecompose(ref_kmeans_signature, hints=hints, name="km",
                     base_p=JPVector(**base_p) if base_p else None)
    jm = jselect_metrics(jnormalized(ref_kmeans_signature, False), False)
    want = jpriors.elasticity_priors(jpb, jm)

    sig = signature_from_reference(dataclasses.asdict(ref_kmeans_signature))
    pb = decompose(sig, hints=WORKLOADS["kmeans"].hints, name="km",
                   base_p=PVector(**base_p) if base_p else None)
    metrics = select_metrics(normalized_vector(sig, False), False)
    assert list(metrics) == list(jm)
    got = tpriors.elasticity_priors(pb, metrics)
    assert dict(got.slopes) == dict(want.slopes)
    assert got.covered == want.covered and got.covered
    assert got.confidence == want.confidence == tpriors.PRIOR_CONFIDENCE


def test_constants_equal_the_reference():
    assert tpriors.PRIOR_CONFIDENCE == jpriors.PRIOR_CONFIDENCE
    assert tpriors.PRIOR_FIELDS == jpriors.PRIOR_FIELDS
    assert tpriors.PRIOR_FAMILIES == jpriors.PRIOR_FAMILIES
    assert tpriors.RATE_METRICS == jpriors.RATE_METRICS


def _chain(ds0=1 << 12, w0=1.0, ds1=1 << 12, w1=1.0, mod=None):
    """The reference test's two-node chain, in either package."""
    P, N, B = ((JPVector, JMotifNode, JProxyBenchmark) if mod == "ref"
               else (PVector, MotifNode, ProxyBenchmark))
    p = P(data_size=1 << 12)
    pb = B("t", (N("n0", "sort", "quick", p.replace(data_size=ds0,
                                                      weight=w0)),
                 N("n1", "statistics", "average",
                   p.replace(data_size=ds1, weight=w1), deps=("n0",))))
    pb.validate()
    return pb


def _mix_eval(pb):
    """Metrics with the exact share structure the prior formulas assume."""
    a, b = pb.node("n0").p, pb.node("n1").p
    ba, bb = a.repeats * a.data_size, b.repeats * b.data_size
    t = ba + bb
    return {"mix_sort": ba / t, "mix_reduce": bb / t,
            "transcendental_frac": 0.2 * bb / t}


def test_rows_the_prior_cannot_fill():
    pb = _chain()
    table = tpriors.elasticity_priors(
        pb, ["flops_rate", "coll_frac", "coll_all_reduce_frac", "unknown"])
    assert table.get("n0.weight", "flops_rate") == 0.0
    assert table.get("n0.weight", "coll_frac") is None  # no mesh
    assert table.get("n0.weight", "unknown") is None
    assert table.covered == frozenset()  # a partial prior covers nothing
    want = jpriors.elasticity_priors(
        _chain(mod="ref"),
        ["flops_rate", "coll_frac", "coll_all_reduce_frac", "unknown"])
    assert dict(table.slopes) == dict(want.slopes)


def test_seed_num_tasks_without_a_mesh_is_the_identity():
    pb = _chain()
    assert tpriors.seed_num_tasks(pb, None) is pb
    with pytest.raises(NotImplementedError, match="mesh"):
        tpriors.seed_num_tasks(pb, object())
    with pytest.raises(NotImplementedError, match="mesh"):
        tpriors.elasticity_priors(pb, ["mix_sort"], mesh=object())


@pytest.mark.parametrize("confidence", [0.0, -1.0])
def test_prior_table_rejects_a_nonpositive_confidence(confidence):
    with pytest.raises(ValueError, match="confidence"):
        tpriors.PriorTable(confidence=confidence)
    assert tpriors.PriorTable(confidence=0.5).confidence == 0.5


def test_empty_priors_is_bit_identical_to_none():
    start = _chain()
    target = _mix_eval(_chain(ds0=1 << 14, w0=2.0))
    r1 = DecisionTreeTuner(_mix_eval, target, tol=0.1, max_iters=25
                           ).tune(start)
    r2 = DecisionTreeTuner(_mix_eval, target, tol=0.1, max_iters=25,
                           priors=tpriors.EMPTY_PRIORS).tune(start)
    assert r1.proxy == r2.proxy and r1.trace == r2.trace
    assert r1.final_devs == r2.final_devs and r1.evals == r2.evals
    assert r1.prior_seeded is False and r2.prior_seeded is False


def _hand_table(mod):
    """A table on the pipeline stub's own metrics (no prior family names
    them), covering the matrix node's weight."""
    return mod.PriorTable(
        slopes={("n0_matrix.weight", "flow"): 0.6,
                ("n0_matrix.weight", "mix"): 0.3,
                ("n0_matrix.weight", "grain"): 0.5,
                ("n1_statistics.weight", "flow"): 0.9},
        confidence=1.5, covered=frozenset({"n0_matrix.weight"}))


@pytest.mark.parametrize("target,max_iters", [
    ({"flow": 130.0, "mix": 0.9, "grain": 5.0}, 6),
    ({"flow": 60.0, "mix": 0.3, "grain": 9.0}, 10),
])
def test_prior_seeded_tuner_matches_the_reference_on_the_pipeline_stub(
        target, max_iters):
    ref_pb = _ref_chain()
    pb = proxy_from_reference_json(ref_pb.to_json())
    want = JTuner(_stub_metrics, target, tol=0.05, max_iters=max_iters,
                  seed=3, priors=_hand_table(jpriors)).tune(ref_pb)
    got = DecisionTreeTuner(_stub_metrics, target, tol=0.05,
                            max_iters=max_iters, seed=3,
                            priors=_hand_table(tpriors)).tune(pb)
    assert [dataclasses.asdict(t) for t in got.trace] == \
        [dataclasses.asdict(t) for t in want.trace]
    for f in ("qualified", "iterations", "evals", "final_devs",
              "mean_accuracy", "tree_depth", "prior_seeded"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.prior_seeded is True
    assert json.loads(got.proxy.to_json()) == _mapped_json(
        want.proxy.to_json())
    # the covered weight skipped its two impact probes
    cold = DecisionTreeTuner(_stub_metrics, target, tol=0.05, max_iters=0,
                             seed=3).tune(pb)
    seeded = DecisionTreeTuner(_stub_metrics, target, tol=0.05, max_iters=0,
                               seed=3, priors=_hand_table(tpriors)).tune(pb)
    assert cold.evals - seeded.evals == 2


def test_derived_priors_drive_both_tuners_alike():
    start, jstart = _chain(), _chain(mod="ref")
    target = _mix_eval(_chain(ds0=1 << 14, w0=2.0))
    got = DecisionTreeTuner(_mix_eval, target, tol=0.1, max_iters=30,
                            priors=tpriors.elasticity_priors(
                                start, sorted(target))).tune(start)
    want = JTuner(_mix_eval, target, tol=0.1, max_iters=30,
                  priors=jpriors.elasticity_priors(
                      jstart, sorted(target))).tune(jstart)
    assert [dataclasses.asdict(t) for t in got.trace] == \
        [dataclasses.asdict(t) for t in want.trace]
    assert (got.evals, got.qualified, got.prior_seeded) == (
        want.evals, want.qualified, True)
    cold = DecisionTreeTuner(_mix_eval, target, tol=0.1, max_iters=30
                             ).tune(start)
    assert got.qualified and got.evals < cold.evals


def test_blended_update_is_prior_weighted():
    start = _chain()
    target = _mix_eval(start)  # on target: the impact batch alone runs
    table = tpriors.elasticity_priors(start, sorted(target))
    tuner = DecisionTreeTuner(_mix_eval, target, tol=0.1, priors=table)
    tuner.tune(start)
    key = ("n0.weight", "mix_sort")
    prior, c = table.slopes[key], tpriors.PRIOR_CONFIDENCE
    assert tuner.elasticity[key] == prior
    tuner._observe(key, 1.0)
    assert math.isclose(tuner.elasticity[key], (c * prior + 1.0) / (c + 1))
    tuner._observe(key, 0.0)
    assert math.isclose(tuner.elasticity[key], (c * prior + 1.0) / (c + 2))


def _kmeans(session, **kw):
    w = WORKLOADS["kmeans"]
    args = w.inputs(seed=0, scale=0.005, device="cpu")
    return generate_proxy(
        w.step, *args, hints=w.hints,
        base_p=PVector(data_size=2 ** 11, chunk_size=64, num_tasks=2),
        max_iters=1, run=False, device="cpu", session=session, **kw)


def test_generate_proxy_inherits_the_session_priors_flag():
    cold_s = EvalSession(run=False, device="cpu")
    _, cold = _kmeans(cold_s, name="cold")
    _, seeded = _kmeans(cold_s, name="seeded", priors=True)
    assert cold.prior_seeded is False and seeded.prior_seeded is True
    assert seeded.evals < cold.evals  # covered probes were skipped
    s = EvalSession(run=False, device="cpu", priors=True)
    _, inherited = _kmeans(s, name="inherit")
    assert inherited.prior_seeded is True
    assert inherited.evals == seeded.evals
    _, opted_out = _kmeans(s, name="optout", priors=False)
    assert opted_out.prior_seeded is False
    _, table = _kmeans(s, name="table", priors=tpriors.EMPTY_PRIORS)
    assert table.prior_seeded is False and table.evals == cold.evals
