"""The port's population form (``ProxyBenchmark.build_lifted_fn``,
``BatchEvaluator.population_runtime``, ``PopulationRegistry``), its
compile-worker pool, the batching rules of the three kernel ops on its
path, and ``tuner_bench``, against the reference's.

Class, build and registry counts come from structural keys that are
equal in both packages, so the same population gives the same counts.
A lane of the population form at repeat count ``r`` must equal the
static build at weight ``r`` bit for bit, and every vmapped lane its
candidate's eval form.  The ops' vmapped CPU forms are held against a
loop over their lanes (sorts exact, products and moments ``rtol=1e-5,
atol=1e-5``) and against ``jax.vmap`` of the reference's plain version
on the same numpy inputs.
"""
import ast
import os
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_np, np_rand, to_jax, to_torch

from repro.core import BatchEvaluator as JBatchEvaluator
from repro.core import EvalSession as JEvalSession
from repro.core.motifs import PVector as JPVector
from repro.core.proxy_graph import MotifNode as JMotifNode
from repro.core.proxy_graph import ProxyBenchmark as JProxyBenchmark
from repro.kernels import ref as jref
from repro_torch.bench import tuner_bench
from repro_torch.core import BatchEvaluator, EvalSession, PopulationRegistry
from repro_torch.core.evaluator import PopulationEntry, vmap_reason
from repro_torch.core.motifs import PVector
from repro_torch.core.proxy_graph import (MotifNode, ProxyBenchmark,
                                          linear_chain)
from repro_torch.kernels import _build, ops
from repro_torch.kernels import bitonic_sort as tbs
from repro_torch.kernels import matmul as tmm

P = dict(data_size=1 << 10, chunk_size=1 << 6, num_tasks=2, batch_size=2,
         height=8, width=8, channels=4)
TOL = dict(rtol=1e-5, atol=1e-5)
REPO = Path(__file__).resolve().parents[1]


def _pb(motif="sort", variant="", **updates) -> ProxyBenchmark:
    pb = ProxyBenchmark(f"t_{motif}", (MotifNode(
        "n0", motif, variant, PVector(**P).replace(**updates)),))
    pb.validate()
    return pb


def _jpb(motif="sort", variant="", **updates) -> JProxyBenchmark:
    pb = JProxyBenchmark(f"t_{motif}", (JMotifNode(
        "n0", motif, variant, JPVector(**P).replace(**updates)),))
    pb.validate()
    return pb


def _leaves(tree):
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    return [tree]


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def _lane(tree, j):
    return {k: _lane(v, j) if isinstance(v, dict) else v[j]
            for k, v in tree.items()}


#: (motif, variant, updates) of a population: weights, a lifted knob and a
#: resized class
POPULATION = (("sort", "", {"weight": 1.0}), ("sort", "", {"weight": 2.0}),
              ("sort", "", {"weight": 3.0}), ("sort", "", {"sparsity": 0.5}),
              ("sort", "", {"data_size": 2048}))


# -- population_runtime against the reference --------------------------------


def test_population_runtime_vmaps_weight_classes_as_the_reference():
    pop = [_pb(m, v, **u) for m, v, u in POPULATION]
    jpop = [_jpb(m, v, **u) for m, v, u in POPULATION]
    ev = BatchEvaluator(run=False, device="cpu")
    jev = JBatchEvaluator(run=False)
    out, jout = ev.population_runtime(pop, iters=1), \
        jev.population_runtime(jpop, iters=1)
    for k in ("classes", "compiles", "candidates", "devices"):
        assert out[k] == jout[k], k
    assert (out["classes"], out["compiles"], out["candidates"]) == (2, 2, 5)
    assert set(jout) <= set(out)
    assert out["wall_time"] > 0.0
    assert [m["mode"] for m in out["modes"].values()] == ["vmap", "vmap"]
    again, jagain = ev.population_runtime(pop, iters=1), \
        jev.population_runtime(jpop, iters=1)
    assert again["compiles"] == jagain["compiles"] == 0
    assert ev.stats()["pop_hits"] == jev.stats()["pop_hits"] == 2


def test_population_registry_shared_across_session_workloads():
    s = EvalSession(run=False, device="cpu")
    js = JEvalSession(run=False)
    for sess, make in ((s, _pb), (js, _jpb)):
        with sess.workload("a"):
            sess.population_runtime([make()], iters=1)
        with sess.workload("b"):
            out = sess.population_runtime([make(weight=2.0)], iters=1)
        assert out["compiles"] == 0  # b reuses a's population form
    for k in ("pop_hits", "pop_builds", "pop_entries"):
        assert s.stats()[k] == js.stats()[k], k
    assert s.stats()["pop_builds"] == 1
    assert s.workload_stats["b"]["pop_hits"] == 1
    assert "pop_entries" not in s.workload_stats["b"]  # a gauge


def test_population_registry_is_an_lru():
    reg = PopulationRegistry(capacity=4)
    for i in range(6):
        reg.get_or_build(("k", i), lambda: object())
    assert len(reg) == 4 and reg.builds == 6
    reg.get_or_build(("k", 2), lambda: pytest.fail("rebuilt a live entry"))
    reg.get_or_build(("k", 6), lambda: object())
    reg.get_or_build(("k", 2), lambda: pytest.fail("evicted the newest"))
    assert reg.stats() == {"pop_hits": 2, "pop_builds": 7, "pop_entries": 4}


def test_population_chunks_hold_at_most_max_batch_lanes(monkeypatch):
    ev = BatchEvaluator(run=False, device="cpu", max_batch=2)
    widths = []
    real = PopulationEntry.runner

    def spy(self, seed, vals, rows):
        widths.append(vals.shape[0])
        return real(self, seed, vals, rows)

    monkeypatch.setattr(PopulationEntry, "runner", spy)
    ev.population_runtime([_pb(weight=float(w)) for w in range(1, 6)],
                          iters=1)
    assert widths == [2, 2, 1]


def test_population_chunks_are_the_runtime_chunks():
    ev = BatchEvaluator(run=False, device="cpu", max_batch=2)
    pop = [_pb(weight=float(w)) for w in (3, 1, 5, 2, 4)] + \
        [_pb(data_size=2048)]
    chunks = list(ev.population_chunks(pop))
    assert [len(c.members) for c in chunks] == [2, 2, 1, 1]
    assert [c.members for c in chunks] == [pop[0:2], pop[2:4], pop[4:5],
                                           pop[5:6]]
    assert [c.caps for c in chunks] == [[3], [5], [4], [1]]
    assert [tuple(c.vals.shape) for c in chunks] == [(2, 1, 4), (2, 1, 4),
                                                     (1, 1, 4), (1, 1, 4)]
    assert len({c.key for c in chunks}) == 2 and ev.pop_registry.builds == 2
    assert chunks[0].entry is chunks[2].entry
    out = ev.population_runtime(pop, iters=1)
    assert (out["classes"], out["compiles"]) == (2, 0)  # built above


# -- the population form -------------------------------------------------------


def test_lifted_fn_matches_static_weights():
    """The population form at reps=r equals the static build at weight=r
    (same seed, same graph), bit for bit."""
    pb = _pb("sort")
    lifted = pb.build_lifted_fn("cpu")
    for w in (1.0, 3.0):
        cand = pb.with_node("n0", weight=w)
        assert _equal(cand.build_fn("cpu")(0),
                      lifted(0, cand.lifted_values("cpu"))), w


@pytest.mark.parametrize("motif", ["sort", "matrix", "statistics"])
def test_lifted_fn_matches_the_eval_form_at_each_weight(motif):
    """The population form at reps=r equals the eval form at weight=r bit
    for bit (the eval form, not the static build: a lifted sparsity of 0
    still draws its mask, a static one does not)."""
    pb = _pb(motif)
    lifted = pb.build_lifted_fn("cpu")
    for w in (1.0, 2.0, 3.0):
        cand = pb.with_node("n0", weight=w)
        vals = cand.lifted_values("cpu")
        assert _equal(cand.build_eval_fn("cpu")(0, vals), lifted(0, vals)), w


@pytest.mark.parametrize("substrate", ["torch", "hopper"])
def test_vmapped_lanes_equal_each_candidates_eval_form(substrate):
    """K-means' motif chain: each lane of one vmapped call, at its own
    weights and lifted knobs, equals that candidate's eval form."""
    p = PVector(**P).replace(substrate=substrate, distribution="normal")
    base = linear_chain("k", [("matrix", "euclidean", p),
                              ("statistics", "average", p),
                              ("sort", "quick", p)])
    ids = [n.id for n in base.nodes]
    cands = [base,
             base.with_node(ids[0], weight=3.0),
             base.with_node(ids[1], weight=2.0, sparsity=0.5),
             base.with_node(ids[2], weight=4.0, dist_scale=2.0)]
    assert len({c.shape_signature(False) for c in cands}) == 1
    entry = PopulationEntry(base.build_lifted_fn("cpu"))
    rows = [[n.p.lifted_row() for n in c.nodes] for c in cands]
    vals = torch.tensor(rows, dtype=torch.float32)
    out = entry.runner(0, vals, rows)()
    assert entry.mode == {"mode": "vmap"}
    for j, c in enumerate(cands):
        want = c.build_eval_fn("cpu")(0, c.lifted_values("cpu"))
        assert _equal(want, _lane(out, j)), j


#: the (motif, variant) classes whose population form does not vmap when
#: their zipf-distributed inputs vary by lane: an in-place scatter into an
#: unbatched buffer (``index_add_``/``scatter_reduce_``)
LANE_BY_LANE = {("graph", "traversal"), ("graph", "pagerank_iter"),
                ("statistics", "degree")}


def _variants():
    from repro_torch.core.motifs import MOTIFS

    return [(m, v) for m in sorted(MOTIFS) for v in MOTIFS[m].variants]


@pytest.mark.parametrize("motif,variant", _variants())
def test_each_variant_vmaps_or_says_why(motif, variant):
    """Every motif variant's population form, over lanes that differ in
    weight and every lifted knob: vmapped, or lane by lane with the op and
    its file:line; either way each lane equals its candidate's eval form
    (``groupby``'s float sums to the reassociation of a batched
    ``index_add``)."""
    pb = _pb(motif, variant, distribution="zipf")
    cands = [pb, pb.with_node("n0", weight=3.0, sparsity=0.5),
             pb.with_node("n0", weight=2.0, dist_scale=2.0, zipf_alpha=1.7)]
    entry = PopulationEntry(pb.build_lifted_fn("cpu"))
    rows = [[n.p.lifted_row() for n in c.nodes] for c in cands]
    out = entry.runner(0, torch.tensor(rows), rows)()
    if (motif, variant) in LANE_BY_LANE:
        assert entry.mode["mode"] == "lanes"
        assert " at repro_torch/core/motifs/" in entry.mode["reason"]
        lanes = out
    else:
        assert entry.mode == {"mode": "vmap"}
        lanes = [_lane(out, j) for j in range(len(cands))]
    for c, got in zip(cands, lanes):
        want = c.build_eval_fn("cpu")(0, c.lifted_values("cpu"))
        for w, g in zip(_leaves(want), _leaves(got)):
            if (motif, variant) == ("set", "groupby"):
                np.testing.assert_allclose(as_np(g), as_np(w), **TOL)
            else:
                assert torch.equal(w, g)


@pytest.fixture
def no_view_dtype_rule():
    """torch 2.11 has no batching rule for ``aten::view.dtype``; the
    installed torch's rule is replaced by one that raises for the test."""
    import warnings

    lib = torch.library.Library("aten", "IMPL")

    def no_rule(*args, **kwargs):
        raise RuntimeError("Batching rule not implemented for "
                           "aten::view.dtype")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # overriding a registered kernel
        lib.impl("view.dtype", no_rule, "FuncTorchBatched")
    yield
    lib._destroy()


@pytest.mark.parametrize("substrate", ["torch", "hopper"])
@pytest.mark.parametrize("motif,variant", [
    ("sort", "quick"), ("sort", "merge"), ("set", "join"),
    ("logic", "crc"), ("sampling", "topk"), ("matrix", "euclidean")])
def test_uint32_lanes_vmap_without_a_view_dtype_rule(
        no_view_dtype_rule, substrate, motif, variant):
    """uint32 leaves (keys, payloads, bits) under vmap reinterpret their
    bits by conversion, not by a dtype view, bit for bit the same."""
    with pytest.raises(RuntimeError, match="view.dtype"):
        torch.func.vmap(lambda v: v.view(torch.int32))(torch.ones(2, 3))
    pb = _pb(motif, variant, substrate=substrate, distribution="zipf")
    cands = [pb, pb.with_node("n0", weight=3.0, sparsity=0.5),
             pb.with_node("n0", weight=2.0, zipf_alpha=1.7)]
    entry = PopulationEntry(pb.build_lifted_fn("cpu"))
    rows = [[n.p.lifted_row() for n in c.nodes] for c in cands]
    out = entry.runner(0, torch.tensor(rows), rows)()
    assert entry.mode == {"mode": "vmap"}
    for j, c in enumerate(cands):
        assert _equal(c.build_eval_fn("cpu")(0, c.lifted_values("cpu")),
                      _lane(out, j)), j


def test_reinterpret_is_a_view_outside_vmap_and_a_conversion_inside():
    from repro_torch.uint32 import reinterpret

    x = to_torch(np_rand(8, (4, 5), "uint32"))
    assert reinterpret(x, torch.int32).data_ptr() == x.data_ptr()  # a view
    assert torch.equal(reinterpret(x, torch.int32), x.view(torch.int32))
    got = torch.func.vmap(lambda v: reinterpret(v, torch.int32))(x)
    assert torch.equal(got, x.view(torch.int32))
    back = torch.func.vmap(lambda v: reinterpret(v, torch.uint32))(got)
    assert torch.equal(back.view(torch.int32), got)


def test_population_runtime_reports_a_lane_by_lane_class():
    pb = _pb("statistics", "degree", distribution="zipf")
    out = BatchEvaluator(run=False, device="cpu").population_runtime(
        [pb, pb.with_node("n0", zipf_alpha=2.0, weight=2.0)], iters=1)
    (mode,) = out["modes"].values()
    assert mode["mode"] == "lanes"
    assert mode["reason"].startswith("vmap: index_add_")
    assert "repro_torch/core/motifs/base.py:" in mode["reason"]
    assert mode["timing"]["mode"] == "eager"


def test_vmap_reason_names_an_op_that_hit_the_fallback():
    from repro_torch.core.evaluator import no_vmap_fallback

    with pytest.raises(RuntimeError) as err, no_vmap_fallback():
        torch.func.vmap(lambda v: torch.bincount(v))(
            torch.zeros(2, 3, dtype=torch.int64))
    assert vmap_reason(err.value).startswith("aten::bincount at ")
    assert torch._C._functorch._is_vmap_fallback_enabled()


# -- the kernel ops' batching rules --------------------------------------------


@pytest.mark.parametrize("op", ["matmul", "row_moments",
                                "bitonic_sort_blocks"])
def test_op_has_a_batching_rule(op):
    assert torch._C._dispatch_has_kernel_for_dispatch_key(
        f"repro_torch::{op}", "FuncTorchBatched")


def _vmap_strict(fn, *args, in_dims=0):
    """vmap with functorch's per-lane fallback disabled: an op without a
    batching rule raises instead of looping."""
    from repro_torch.core.evaluator import no_vmap_fallback

    with no_vmap_fallback():
        return torch.func.vmap(fn, in_dims=in_dims)(*args)


@pytest.mark.parametrize("dims", [(0, None), (None, 0), (0, 0), (1, 2)])
def test_vmapped_matmul_equals_the_loop_and_the_reference(dims):
    lanes, m, k, n = 3, 17, 24, 5
    x = np_rand(1, (lanes, m, k), "float32")
    y = np_rand(2, (lanes, k, n), "float32")
    xs = x if dims[0] is not None else x[0]
    ys = y if dims[1] is not None else y[0]
    tx, ty = to_torch(xs), to_torch(ys)
    if dims == (1, 2):  # lanes on another dim
        tx, ty = tx.movedim(0, 1), ty.movedim(0, 2)
    got = _vmap_strict(ops.matmul, tx, ty, in_dims=dims)
    for j in range(lanes):
        want = ops.matmul(to_torch(xs[j] if dims[0] is not None else xs),
                          to_torch(ys[j] if dims[1] is not None else ys))
        np.testing.assert_allclose(as_np(got[j]), as_np(want), **TOL)
    jdims = tuple(None if d is None else 0 for d in dims)
    jwant = jax.vmap(jref.matmul, in_axes=jdims)(to_jax(xs), to_jax(ys))
    np.testing.assert_allclose(as_np(got), np.asarray(jwant), **TOL)


@pytest.mark.parametrize("shape", [(4, 6, 33), (2, 3, 5, 40)])
def test_vmapped_row_moments_equal_the_loop_and_the_reference(shape):
    x = np_rand(3, shape, "float32")
    mean, msq = _vmap_strict(ops.row_moments, to_torch(x))
    for j in range(shape[0]):
        wm, ws = ops.row_moments(to_torch(x[j]))
        np.testing.assert_allclose(as_np(mean[j]), as_np(wm), **TOL)
        np.testing.assert_allclose(as_np(msq[j]), as_np(ws), **TOL)
    jm, js = jax.vmap(jref.row_moments)(to_jax(x))
    np.testing.assert_allclose(as_np(mean), np.asarray(jm), **TOL)
    np.testing.assert_allclose(as_np(msq), np.asarray(js), **TOL)


@pytest.mark.parametrize("dtype", ["uint32", "int32", "float32", "bfloat16"])
@pytest.mark.parametrize("n,block", [(64, 16), (70, 16), (5, 8)])
def test_vmapped_bitonic_sort_equals_the_loop(dtype, n, block):
    src = np_rand(4, (3, n), "uint32" if dtype in ("uint32", "int32")
                  else "float32")
    x = to_torch(src.view(dtype) if dtype in ("uint32", "int32") else src,
                 "bfloat16" if dtype == "bfloat16" else "")
    got = _vmap_strict(
        lambda v: tbs.bitonic_sort_blocks(v, block=block), x)
    for j in range(3):
        want = tbs.bitonic_sort_blocks(x[j].contiguous(), block=block)
        assert torch.equal(got[j], want), j


def test_vmapped_sort_equals_the_loop_and_the_reference():
    x = np_rand(5, (4, 300), "uint32")
    got = _vmap_strict(lambda v: ops.sort(v, block=64), to_torch(x))
    for j in range(4):
        assert torch.equal(got[j], ops.sort(to_torch(x[j]), block=64))
    np.testing.assert_array_equal(
        as_np(got), np.asarray(jax.vmap(jnp.sort)(to_jax(x))))


def test_launch_counts_are_exact_across_threads():
    """More threads than cores bumping one counter with the interpreter
    switching threads every microsecond: a lost update shows."""
    import sys

    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.forms = {"a": 0}

    def bump():
        for _ in range(2000):
            _build.count_launch(wrapper, "a")

    n = 2 * (os.cpu_count() or 1) + 2
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == wrapper.forms["a"] == 2000 * n


def test_matmul_lanes_keeps_the_plain_version_on_the_cpu():
    x, y = to_torch(np_rand(6, (2, 7, 9), "float32")), \
        to_torch(np_rand(7, (2, 9, 4), "float32"))
    before = tmm.matmul.launches
    got = tmm.matmul_lanes(x, y)
    assert tmm.matmul.launches == before  # no kernel on the CPU
    np.testing.assert_allclose(as_np(got), as_np(x @ y), **TOL)
    with pytest.raises(ValueError, match="lanes"):
        tmm.matmul_lanes(x, torch.cat([y, y]))
    # a 2-D operand is shared by every lane; two 2-D operands are the op
    for a, b in ((x[0], y), (x, y[0]), (x[0], y[0])):
        np.testing.assert_allclose(as_np(tmm.matmul_lanes(a, b)),
                                   as_np(a @ b), **TOL)
    assert tmm.matmul.launches == before
    with pytest.raises(ValueError, match="contiguous"):
        tmm.matmul_lanes(x.transpose(1, 2).contiguous().transpose(1, 2), y)
    with pytest.raises(ValueError, match=r"\(M,K\) @ \(K,N\)"):
        tmm.matmul(x, y)  # the op itself takes no lanes


# -- the compile-worker pool ----------------------------------------------------


def test_compile_workers_defaults_to_auto(monkeypatch):
    monkeypatch.delenv("REPRO_COMPILE_WORKERS", raising=False)
    ev = BatchEvaluator(run=False, device="cpu")
    jev = JBatchEvaluator(run=False)
    assert ev.compile_workers == jev.compile_workers == 0  # 0 = auto
    for n in (1, 3, 64):
        assert ev._effective_workers(n) == jev._effective_workers(n) \
            == min(os.cpu_count() or 1, n)


def test_compile_workers_env_override_and_stats(monkeypatch):
    monkeypatch.setenv("REPRO_COMPILE_WORKERS", "1")
    ev = BatchEvaluator(run=False, device="cpu")
    assert ev.compile_workers == JBatchEvaluator(run=False).compile_workers \
        == 1
    pb = _pb("logic")
    ev.evaluate_batch([pb, pb.with_node("n0", data_size=2048)])
    assert ev.stats()["compile_workers_max"] == 1


def test_auto_workers_recorded_in_stats_and_equal_the_serial_engine(
        monkeypatch):
    monkeypatch.delenv("REPRO_COMPILE_WORKERS", raising=False)
    ev = BatchEvaluator(run=False, device="cpu")
    batch = [_pb("logic", data_size=1 << s) for s in (8, 9, 10)]
    res = ev.evaluate_batch(batch)
    jev = JBatchEvaluator(run=False)
    jev.evaluate_batch([_jpb("logic", data_size=1 << s) for s in (8, 9, 10)])
    assert ev.cache.compiles == jev.cache.compiles == 3
    assert ev.stats()["compile_workers_max"] == \
        jev.stats()["compile_workers_max"] == min(os.cpu_count() or 1, 3)
    serial = BatchEvaluator(run=False, device="cpu", compile_workers=1)
    assert serial.evaluate_batch(batch) == res


def test_generate_proxy_and_session_take_compile_workers():
    import inspect

    from repro_torch.core import generate_proxy

    assert "compile_workers" in inspect.signature(generate_proxy).parameters
    s = EvalSession(run=False, device="cpu", compile_workers=2)
    assert s.engine.compile_workers == 2
    s.evaluate_batch([_pb(data_size=1 << k) for k in (8, 9, 10)])
    assert s.stats()["compile_workers_max"] == 2


# -- tuner_bench ------------------------------------------------------------------


def _reference_doc_keys():
    """Top-level keys of the reference's ``out_doc.update({...})`` dicts,
    by the function that builds them, read from its source."""
    tree = ast.parse((REPO / "benchmarks" / "tuner_bench.py").read_text())
    keys = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "attr", "") == "update"
                    and node.args and isinstance(node.args[0], ast.Dict)):
                keys[fn.name] = {k.value for k in node.args[0].keys}
    return keys


def test_doc_keys_are_the_reference_documents():
    ref = _reference_doc_keys()
    for mode, fn in (("single", "run_single"), ("sweep", "run_sweep"),
                     ("priors", "run_priors")):
        assert set(tuner_bench.DOC_KEYS[mode][""]) == ref[fn], mode
    from benchmarks import tuner_bench as jbench

    assert tuner_bench.SWEEP == jbench.SWEEP
    assert tuner_bench.PRIOR_CHAIN == jbench.PRIOR_CHAIN
    # the same P but for the substrate's name (the reference's "xla")
    assert tuner_bench.SMALL_P.replace(substrate="xla").__dict__ == \
        jbench.SMALL_P.__dict__


def test_impact_batch_and_qualification_equal_the_reference():
    from benchmarks import tuner_bench as jbench
    from repro.core.proxy_graph import linear_chain as jchain

    pb = linear_chain("bench", [(m, "", tuner_bench.SMALL_P)
                                for m in ("sort", "statistics")])
    jpb = jchain("bench", [(m, "", jbench.SMALL_P)
                           for m in ("sort", "statistics")])
    batch, jbatch = tuner_bench.impact_batch(pb), jbench.impact_batch(jpb)
    assert [b.shape_signature() for b in batch] == \
        [b.shape_signature() for b in jbatch]
    assert tuner_bench.qualification_profile(batch) == \
        jbench.qualification_profile(jbatch)


@pytest.mark.parametrize("mode", [[], ["--sweep"]])
def test_tuner_bench_quick_modes_pass_with_the_reference_keys(mode, tmp_path):
    out = tmp_path / "doc.json"
    trace = tmp_path / "trace.json"
    rc = tuner_bench.main(["--quick", "--device", "cpu", "--out", str(out),
                           "--trace", str(trace), *mode])
    assert rc == 0
    import json

    doc = json.loads(out.read_text())
    assert tuner_bench.missing_keys(doc) == []
    assert doc["trace"]["events"] > 0 and trace.exists()
    if not mode:
        assert doc["parity_gap"] == 0.0
        assert doc["qualification"]["rounded_rate"] == 1.0
        assert all(m["mode"] == "vmap"
                   for m in doc["population"]["modes"].values())
    else:
        assert doc["shared"]["compiles"] < doc["separate"]["compiles"]
        assert doc["shared"]["cross_workload_hits"] > 0


def test_tuner_bench_priors_exit_code_is_its_gate(tmp_path):
    """``--priors`` at the reference's setup (budget 16, stock forms):
    every reference key, and the exit code the reference's gate gives
    the document (the prior run qualifies, in fewer evaluator calls than
    a qualified cold run).  On the port's profile that gate does not
    hold yet (ROADMAP queue 3); the exit code must say so."""
    import json

    out = tmp_path / "doc.json"
    rc = tuner_bench.main(["--quick", "--priors", "--device", "cpu",
                           "--out", str(out)])
    doc = json.loads(out.read_text())
    assert tuner_bench.missing_keys(doc) == []
    assert doc["max_iters"] == 16 and doc["tol"] == 0.15
    cold, prior = doc["cold"], doc["prior"]
    holds = prior["qualified"] and not (
        cold["qualified"] and prior["evals"] >= cold["evals"])
    assert rc == (0 if holds else 1)
    # a covered param skips both of its impact probes (x2 and x1/2)
    assert prior["prior_params"] == 2 * len(doc["motifs"])
    assert prior["evals"] - prior["iterations"] == \
        cold["evals"] - cold["iterations"] - 2 * prior["prior_params"]
