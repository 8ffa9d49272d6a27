"""TeraSort and PageRank in the port against the JAX package, on the same
inputs.

Inputs are numpy arrays made from a seed and handed to both packages; the
reference's step runs under one ``jax.jit``.  TeraSort's step is exact
(a stable sort, its searches and gathers of uint32 keys).  PageRank's
ranks, top ranks and delta are f32 sums over in-edges in another order,
``rtol=1e-5, atol=1e-7``; its in-degrees are exact.  Each workload's
inputs are held to the reference's configuration (``jax.eval_shape`` of
its ``make_inputs``), and ``generate_proxy`` runs on each end to end at a
small scale on the CPU.
"""
import jax
import numpy as np
import pytest
import torch

from torch_parity import KernelOps, as_np, to_jax, to_torch

from repro.workloads import WORKLOADS as JWORKLOADS
from repro_torch.core.generator import generate_proxy
from repro_torch.core.motifs import PVector
from repro_torch.workloads import WORKLOADS

PAGERANK_TOL = dict(rtol=1e-5, atol=1e-7)
#: the repro_torch ops each workload's tuned hopper proxy must reach (on
#: the CPU, their plain versions): PageRank's hinted variants are all
#: declined by the lowering
PROXY_KERNEL_OPS = {"terasort": {"bitonic_sort_blocks"}, "pagerank": set()}


def test_the_port_registers_the_five_workloads():
    assert sorted(WORKLOADS) == sorted(JWORKLOADS)
    for name, w in WORKLOADS.items():
        assert [(h.motif, h.variant, h.weight, h.overrides())
                for h in w.hints] == [
            (h.motif, h.variant, h.weight, h.overrides())
            for h in JWORKLOADS[name].hints], name


def _terasort_inputs(seed, n, key_range):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_range, n, dtype=np.uint64).astype(np.uint32)
    payload = rng.integers(0, 1 << 32, (n, 24), dtype=np.uint64).astype(
        np.uint32)
    return keys, payload


@pytest.mark.parametrize("n,key_range", [
    (4096, 1 << 32),     # the smallest make_inputs allows
    (5000, 997),         # many repeated keys: the argsort must be stable
    (70_001, 1 << 32),   # a sample stride above 1
])
def test_terasort_step_matches_reference(n, key_range):
    keys, payload = _terasort_inputs(n, n, key_range)
    want = jax.jit(JWORKLOADS["terasort"].step)(to_jax(keys), to_jax(payload))
    got = WORKLOADS["terasort"].step(to_torch(keys), to_torch(payload))
    assert len(got) == len(want) == 3
    for w, g in zip(want, got):
        assert g.dtype == getattr(torch, str(w.dtype))
        np.testing.assert_array_equal(as_np(g), np.asarray(w))


def _pagerank_inputs(seed, v, uniform_ranks):
    rng = np.random.default_rng(seed)
    e = 16 * v
    src = rng.integers(0, v, e).astype(np.int32)
    dst = ((rng.zipf(1.3, e) - 1) % v).astype(np.int32)  # hub vertices
    ranks = (np.full(v, 1.0 / v, np.float32) if uniform_ranks
             else rng.random(v).astype(np.float32) / v)
    return src, dst, ranks


@pytest.mark.parametrize("v,uniform_ranks", [(4096, True), (5000, False)])
def test_pagerank_step_matches_reference(v, uniform_ranks):
    src, dst, ranks = _pagerank_inputs(v, v, uniform_ranks)
    want = jax.jit(JWORKLOADS["pagerank"].step)(to_jax(src), to_jax(dst),
                                                to_jax(ranks))
    got = WORKLOADS["pagerank"].step(to_torch(src), to_torch(dst),
                                     to_torch(ranks))
    for what, w, g in zip(("ranks", "top", "delta", "in_deg"), want, got):
        w, g = np.asarray(w), as_np(g)
        assert w.shape == g.shape and w.dtype == g.dtype, what
        if what == "in_deg":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, err_msg=what, **PAGERANK_TOL)


@pytest.mark.parametrize("name,scale", [
    ("terasort", 0.002), ("terasort", 0.01), ("pagerank", 0.01),
    ("pagerank", 0.03),
])
def test_inputs_match_the_reference_configuration(name, scale):
    got = WORKLOADS[name].inputs(seed=0, scale=scale, device="cpu")
    want = jax.eval_shape(lambda k: JWORKLOADS[name].inputs(k, scale),
                          jax.random.key(0))
    assert [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in got] == [(w.shape, str(w.dtype)) for w in want]
    if name == "pagerank":
        src, dst, ranks = got
        v = ranks.shape[0]
        assert int(src.max()) < v and int(dst.max()) < v
        assert torch.equal(ranks, torch.full((v,), 1.0 / v))
        # zipf destinations: the busiest vertex takes far more than 16
        assert int(torch.bincount(dst.long()).max()) > 100 * 16


@pytest.mark.parametrize("name,scale", [("terasort", 0.002),
                                        ("pagerank", 0.016)])
def test_generate_proxy_end_to_end(name, scale):
    w = WORKLOADS[name]
    args = w.inputs(seed=0, scale=scale, device="cpu")
    pb, rep = generate_proxy(
        w.step, *args, name=name, hints=w.hints,
        base_p=PVector(data_size=2 ** 11, chunk_size=64, num_tasks=2),
        max_iters=2, run=False, substrate="hopper", device="cpu")
    pb.validate()
    assert [(n.motif, n.variant) for n in pb.nodes] == [
        (h.motif, h.variant) for h in w.hints]
    assert {n.p.substrate for n in pb.nodes} == {"hopper"}
    assert 0.0 <= rep.mean_accuracy <= 1.0
    assert rep.iterations <= 2 and rep.speedup is None
    assert rep.device == "cpu" and rep.engine_stats["compiles"] > 0
    with KernelOps() as seen:
        pb.build_eval_fn("cpu")(0, pb.lifted_values("cpu"))
    assert seen.ops == PROXY_KERNEL_OPS[name]
