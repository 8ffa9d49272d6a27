"""The port's pipeline — proxy IR, signature, accuracy, decomposition,
evaluator, tuner, generator and the K-means workload — against the JAX
package on the same inputs.

Pure logic (P keys, shape signatures, proxy JSON, Eq. 3, decomposition
of a given signature, the CART tuner on a deterministic evaluator) must
agree exactly.  The K-means step's counts and order are exact; its
centroids and inertia are f32 sums in another order, ``rtol=1e-4,
atol=1e-5``.  Generators are held to their distributions, not streams.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_np, np_rand, to_jax, to_torch

from repro.core import accuracy as jacc
from repro.core.decompose import decompose as jdecompose
from repro.core.motifs import PVector as JPVector
from repro.core.proxy_graph import linear_chain as jlinear_chain
from repro.core.signature import (_local_stats, _split_computations,
                                  signature_of_jitted)
from repro.core.tuner import DecisionTreeTuner as JTuner
from repro.data.generators import zipf_probs as jzipf_probs
from repro.workloads import WORKLOADS as JWORKLOADS
from repro_torch import resolve_device
from repro_torch.convert import (proxy_from_reference_json,
                                 signature_from_reference)
from repro_torch.core import accuracy as tacc
from repro_torch.core.decompose import decompose
from repro_torch.core.evaluator import BatchEvaluator
from repro_torch.core.generator import generate_proxy, proxy_metrics
from repro_torch.core.motifs import PVector, get_motif
from repro_torch.core.proxy_graph import ProxyBenchmark, linear_chain
from repro_torch.core.signature import profile_call
from repro_torch.core.tuner import DecisionTreeTuner
from repro_torch.data import generators as tgen
from repro_torch.kernels import ops
from repro_torch.workloads import WORKLOADS

SUB = {"xla": "torch", "pallas": "hopper"}
P_CHAIN = dict(data_size=1024, chunk_size=64, num_tasks=2)


def _ref_chain(substrate="xla"):
    return jlinear_chain("t", [
        ("matrix", "euclidean", JPVector(**P_CHAIN, substrate=substrate)),
        ("statistics", "average", JPVector(weight=2.0, **P_CHAIN,
                                           substrate=substrate)),
        ("sort", "quick", JPVector(**P_CHAIN, substrate=substrate)),
    ], meta={"origin": "reference"})


def _mapped_json(text: str) -> dict:
    d = json.loads(text)
    for nd in d["nodes"]:
        nd["p"]["substrate"] = SUB[nd["p"]["substrate"]]
    return d


def _map_key(key):
    return tuple(_map_key(v) if isinstance(v, tuple) else SUB.get(v, v)
                 for v in key)


# -- proxy IR ---------------------------------------------------------------


@pytest.mark.parametrize("substrate", ["xla", "pallas"])
def test_reference_json_round_trips(substrate):
    ref = _ref_chain(substrate)
    pb = proxy_from_reference_json(ref.to_json())
    assert json.loads(pb.to_json()) == _mapped_json(ref.to_json())
    assert ProxyBenchmark.from_json(pb.to_json()) == pb
    for rep in (True, False):
        assert pb.shape_signature(rep) == _map_key(ref.shape_signature(rep))
    np.testing.assert_array_equal(as_np(pb.lifted_values("cpu")),
                                  np.asarray(ref.lifted_values()))


def test_with_substrate_identity_and_rewrite():
    pb = linear_chain("t", [("sort", "quick", PVector(data_size=512))])
    assert pb.with_substrate("torch") is pb
    hop = pb.with_substrate("hopper")
    assert {n.p.substrate for n in hop.nodes} == {"hopper"}
    assert hop.shape_signature() != pb.shape_signature()
    assert hop.with_substrate("torch").shape_signature() == \
        pb.shape_signature()


# -- decomposition ------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_kmeans_signature():
    w = JWORKLOADS["kmeans"]
    args = w.inputs(jax.random.key(0), scale=0.02)
    return signature_of_jitted(w.step, *args, run=False)


@pytest.mark.parametrize("base_p", [None, dict(data_size=1 << 11,
                                               chunk_size=64, num_tasks=2)])
def test_decompose_matches_reference(ref_kmeans_signature, base_p):
    hints = JWORKLOADS["kmeans"].hints
    want = jdecompose(ref_kmeans_signature, hints=hints, name="km",
                      base_p=JPVector(**base_p) if base_p else None)
    sig = signature_from_reference(dataclasses.asdict(ref_kmeans_signature))
    got = decompose(sig, hints=WORKLOADS["kmeans"].hints, name="km",
                    base_p=PVector(**base_p) if base_p else None)
    assert json.loads(got.to_json()) == _mapped_json(want.to_json())
    assert tacc.normalized_vector(sig, False) == jacc.normalized_vector(
        ref_kmeans_signature, False)


# -- accuracy -----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accuracy_matches_reference(seed):
    rng = np.random.default_rng(seed)
    names = ["a", "b", "c", "d"]
    real = {k: float(v) for k, v in zip(names, rng.uniform(-2, 2, 4))}
    real["z"] = 0.0
    prox = {k: float(v) for k, v in zip(names, rng.uniform(-2, 2, 4))}
    prox["z"] = float(seed % 2)
    assert dataclasses.asdict(tacc.compare(real, prox)) == \
        dataclasses.asdict(jacc.compare(real, prox))
    assert tacc.deviations(real, prox) == jacc.deviations(real, prox)
    for r, p in zip(real.values(), prox.values()):
        assert tacc.eq3_accuracy(r, p) == jacc.eq3_accuracy(r, p)
    assert tacc.DEFAULT_METRICS == jacc.DEFAULT_METRICS
    assert tacc.RATE_METRICS == jacc.RATE_METRICS
    assert tacc.COLLECTIVE_METRICS == jacc.COLLECTIVE_METRICS


# -- the tuner on a deterministic stub evaluator ------------------------------


def _stub_metrics(pb):
    """Metrics as a pure function of the P values (framework-free)."""
    m = {"flow": 0.0, "mix": 0.0, "grain": 0.0}
    for i, n in enumerate(pb.nodes):
        p = n.p
        m["flow"] += math.log2(p.data_size) * p.weight * (i + 1)
        m["mix"] += p.weight / (1.0 + math.log2(p.chunk_size)) + 0.1 * i
        m["grain"] += math.log2(p.num_tasks + 1) * p.weight + \
            0.01 * math.log2(getattr(p, "batch_size", 8) + 1)
    return m


@pytest.mark.parametrize("target,max_iters", [
    ({"flow": 130.0, "mix": 0.9, "grain": 5.0}, 6),
    ({"flow": 60.0, "mix": 0.3, "grain": 9.0}, 10),
])
def test_tuner_matches_reference_on_a_stub(target, max_iters):
    ref_pb = _ref_chain()
    pb = proxy_from_reference_json(ref_pb.to_json())
    want = JTuner(_stub_metrics, target, tol=0.05, max_iters=max_iters,
                  seed=3).tune(ref_pb)
    got = DecisionTreeTuner(_stub_metrics, target, tol=0.05,
                            max_iters=max_iters, seed=3).tune(pb)
    assert [dataclasses.asdict(t) for t in got.trace] == \
        [dataclasses.asdict(t) for t in want.trace]
    for f in ("qualified", "iterations", "evals", "final_devs",
              "mean_accuracy", "tree_depth", "qualification_rate"):
        assert getattr(got, f) == getattr(want, f), f
    assert json.loads(got.proxy.to_json()) == _mapped_json(
        want.proxy.to_json())
    assert got.iterations > 0


# -- signatures -----------------------------------------------------------------


def _ref_dominant_class(fn, *args) -> str:
    """The op class with the most output bytes over every computation of
    the reference's compiled program (fused bodies included)."""
    text = jax.jit(fn).lower(*args).compile().as_text()
    totals = {}
    for name, lines in _split_computations(text).items():
        if name == "__entry__":
            continue
        for cls, b in _local_stats(lines).op_bytes.items():
            if cls not in ("control", "other"):
                totals[cls] = totals.get(cls, 0.0) + b
    return max(totals, key=totals.get)


@pytest.mark.parametrize("name,jfn,tfn,nargs", [
    ("matmul", lambda a, b: a @ b, lambda a, b: a @ b, 2),
    ("sort", lambda a: jnp.sort(a, -1), lambda a: torch.sort(a, -1).values, 1),
    ("sum", lambda a: jnp.sum(a, -1), lambda a: torch.sum(a, -1), 1),
])
def test_one_op_programs_land_in_the_reference_class(name, jfn, tfn, nargs):
    xs = [np_rand(1, (256, 64), "float32"), np_rand(2, (64, 32), "float32")]
    jargs = [to_jax(a) for a in xs[:nargs]]
    sig = profile_call(tfn, *[to_torch(a) for a in xs[:nargs]])
    mixes = {k[4:]: v for k, v in sig.vector().items()
             if k.startswith("mix_")}
    assert max(mixes, key=mixes.get) == _ref_dominant_class(jfn, *jargs)
    ref = signature_of_jitted(jfn, *jargs, run=False)
    assert set(sig.vector()) == set(ref.vector())


def test_kernel_ops_are_one_op_each_with_their_own_class():
    x, y = torch.randn(96, 40), torch.randn(40, 24)
    sig = profile_call(ops.matmul, x, y)
    assert sig.dot_flops == sig.flops == 2.0 * 96 * 40 * 24
    assert sig.raw_cost == {"ops_dot": 1.0}
    assert profile_call(ops.row_moments, x).raw_cost == {"ops_reduce": 1.0}
    sig = profile_call(lambda k: ops.bitonic_sort_blocks(k, block=16),
                       torch.randn(100))
    assert sig.raw_cost == {"ops_sort": 1.0}
    assert sig.op_mix == {"sort": 112 * 4.0}


# -- the workload --------------------------------------------------------------


def test_kmeans_step_matches_reference():
    rng = np.random.default_rng(5)
    x = np_rand(8, (2048, 64), "float32")
    x[rng.random(x.shape) < 0.9] = 0.0
    c = np_rand(9, (32, 64), "float32")
    # one compiled program: eager dispatch would compile each op on its own
    jc, jn, ji = jax.jit(JWORKLOADS["kmeans"].step)(to_jax(x), to_jax(c))
    tc, tn, ti = WORKLOADS["kmeans"].step(to_torch(x), to_torch(c))
    np.testing.assert_array_equal(as_np(tn), np.asarray(jn))
    np.testing.assert_allclose(as_np(tc), np.asarray(jc), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(as_np(ti), np.asarray(ji), rtol=1e-4)
    assert tc.shape == (32, 64) and float(tn.sum()) == 2048


def test_kmeans_inputs_match_the_reference_configuration():
    x, c = WORKLOADS["kmeans"].inputs(seed=0, scale=0.005, device="cpu")
    jx, jc = jax.eval_shape(
        lambda key: JWORKLOADS["kmeans"].inputs(key, scale=0.005),
        jax.random.key(0))
    assert x.shape == jx.shape and c.shape == jc.shape
    assert x.dtype == torch.float32
    assert abs(float((x == 0).float().mean()) - 0.9) < 0.02


# -- generators: distributions, not streams -------------------------------------


def test_zipf_probs_equal_reference():
    np.testing.assert_array_equal(tgen.zipf_probs(1000, 1.3),
                                  jzipf_probs(1000, 1.3))


def test_sparsity_and_zipf_distributions():
    gen = tgen.make_generator(0, torch.device("cpu"))
    x = tgen.gen_vectors(gen, 4096, 32,
                         tgen.DataSpec(distribution="normal", sparsity=0.9))
    assert abs(float((x == 0).float().mean()) - 0.9) < 0.01
    n = 200_000
    keys = tgen.gen_keys(gen, n, tgen.DataSpec(distribution="zipf"))
    assert keys.dtype == torch.uint32
    counts = np.bincount(as_np(keys).astype(np.int64), minlength=10)[:10]
    expect = jzipf_probs(min(n, 1 << 16), 1.2)[:10] * n
    assert np.all(np.abs(counts - expect) < 5 * np.sqrt(expect) + 5)
    src, dst = tgen.gen_graph(gen, 500, 1000, tgen.DataSpec("zipf"))
    assert src.dtype == dst.dtype == torch.int32
    assert int(dst.max()) < 500 and int(src.min()) >= 0


def test_liftable_knobs_apply_equal_values_as_tensors():
    """A tensor 0.0 sparsity and 1.0 scale apply the mask and multiply but
    give the values the Python-float fast paths give."""
    def draw(**kw):
        gen = tgen.make_generator(7, torch.device("cpu"))
        return tgen.gen_vectors(gen, 64, 8, tgen.DataSpec(**kw))

    fast = draw(sparsity=0.0, scale=1.0)
    lifted = draw(sparsity=torch.tensor(0.0), scale=torch.tensor(1.0))
    assert torch.equal(fast, lifted)
    prof = profile_call(lambda s: draw(sparsity=s), torch.tensor(0.0))
    assert prof.raw_cost["ops_elementwise"] > profile_call(
        lambda s: draw(sparsity=0.0), torch.tensor(0.0)).raw_cost.get(
            "ops_elementwise", 0)


# -- evaluator, generator, devices ------------------------------------------------


def test_batched_metrics_equal_serial():
    base = linear_chain("e", [("matrix", "euclidean", PVector(**P_CHAIN)),
                              ("sort", "quick", PVector(**P_CHAIN))])
    cands = [base, base.with_node("n0_matrix", sparsity=0.5),
             base.with_node("n1_sort", data_size=2048)]
    ev = BatchEvaluator(run=False, device="cpu")
    batched = ev.evaluate_batch(cands)
    serial = [proxy_metrics(pb, run=False, device="cpu") for pb in cands]
    assert batched == serial
    stats = ev.stats()
    # sparsity is lifted: the first two candidates share one profile
    assert stats["compiles"] == 2 and stats["evals"] == 3
    assert set(stats) == {"hits", "misses", "compiles", "evictions",
                          "cross_workload_hits", "entries", "evals",
                          "pop_hits", "pop_builds", "pop_entries",
                          "compile_workers_max"}


def test_generate_proxy_on_kmeans_end_to_end():
    w = WORKLOADS["kmeans"]
    args = w.inputs(seed=0, scale=0.005, device="cpu")
    pb, rep = generate_proxy(
        w.step, *args, name="km", hints=w.hints,
        base_p=PVector(data_size=2 ** 11, chunk_size=64, num_tasks=2),
        max_iters=2, run=False, substrate="hopper", device="cpu")
    pb.validate()
    assert {(n.motif, n.variant) for n in pb.nodes} == {
        (h.motif, h.variant) for h in w.hints}
    assert {n.p.substrate for n in pb.nodes} == {"hopper"}
    assert 0.0 <= rep.mean_accuracy <= 1.0
    assert rep.iterations <= 2 and rep.speedup is None
    assert rep.device == "cpu" and rep.engine_stats["compiles"] > 0


def test_entry_points_raise_without_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)
    w = WORKLOADS["kmeans"]
    pb = linear_chain("d", [("sort", "quick", PVector(data_size=256))])
    for call in (lambda: w.inputs(0, 0.005),
                 lambda: get_motif("sort").make_inputs(PVector(), 0),
                 lambda: BatchEvaluator(run=False),
                 lambda: pb.build_fn(),
                 lambda: generate_proxy(w.step, name="x", hints=w.hints)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError, match="substrate"):
        generate_proxy(w.step, *w.inputs(0, 0.005, "cpu"), substrate="pallas",
                       device="cpu")
