"""How the port takes wall times (``repro_torch.core.signature``).

On CUDA a wall time is one captured CUDA graph's replays, where the
function can be captured; on the CPU, which has no graphs, it is eager,
and ``Signature.timing`` says so.  The profile (flops, bytes, op mix,
peak memory) is one eager run either way: its values here are the ones
the port gave before timing moved to graphs, on the same proxy.  The
capture itself, and a capture that fails, are held on the card
(``tests/test_torch_cuda.py``).
"""
import json

import pytest
import torch

from torch_parity import to_torch  # noqa: F401  (sets one thread a worker)

from repro_torch.core import (EvalSession, ProxyStore, STORE_VERSION,
                              generate_proxy, signature_of_call)
from repro_torch.core.evaluator import serial_evaluate_batch
from repro_torch.core.motifs import PVector
from repro_torch.core.proxy_graph import MotifNode, ProxyBenchmark
from repro_torch.core.signature import profile_call, timed_wall
from repro_torch.core.store import canonical_key, key_digest
from repro_torch.data.generators import (GeneratorSupply, gen_seed,
                                         generator_from, make_generator)
from repro_torch.workloads import WORKLOADS

CPU = torch.device("cpu")
EAGER = {"mode": "eager", "reason": "no CUDA graph on the cpu"}


def _proxy() -> ProxyBenchmark:
    """Six nodes that reach every knob the timing change touched: lifted
    sparsity, scale and zipf alpha, the graph motif's vertex count, and
    the seed leaves of the sampling motif's random draws."""
    p = PVector(data_size=1 << 10, chunk_size=64, num_tasks=2, batch_size=4,
                height=8, width=8, channels=4, weight=2.0)
    return ProxyBenchmark("timing", (
        MotifNode("m", "matrix", "euclidean",
                  p.replace(distribution="normal", sparsity=0.9,
                            dist_scale=0.5)),
        MotifNode("s", "statistics", "average", p.replace(sparsity=0.5),
                  ("m",)),
        MotifNode("o", "sort", "quick",
                  p.replace(distribution="zipf", zipf_alpha=1.5), ("s",)),
        MotifNode("g", "graph", "traversal", p.replace(distribution="zipf"),
                  ("o",)),
        MotifNode("r", "sampling", "random", p.replace(dist_scale=2.0),
                  ("g",)),
        MotifNode("d", "sampling", "dropout", p, ("r",)),
    ))


#: the profile of ``_proxy()`` as the port gave it with eager timing (the
#: eval form takes its knobs as tensors, the static form as Python floats)
BEFORE = {
    "eval": {"bytes": 1630574.0, "conv_flops": 0.0, "dot_flops": 16384.0,
             "flops": 137197.0, "peak_memory": 0.0,
             "transcendentals": 3328.0,
             "op_mix": {"data_movement": 147876.0, "dot": 512.0,
                        "elementwise": 391828.0, "logic": 59136.0,
                        "reduce": 7292.0, "sort": 33280.0},
             "raw_cost": {"ops_control": 33.0, "ops_data_movement": 244.0,
                          "ops_dot": 2.0, "ops_elementwise": 209.0,
                          "ops_logic": 22.0, "ops_reduce": 41.0,
                          "ops_sort": 4.0}},
    "static": {"bytes": 1605266.0, "conv_flops": 0.0, "dot_flops": 16384.0,
               "flops": 134125.0, "peak_memory": 0.0,
               "transcendentals": 3328.0,
               "op_mix": {"data_movement": 147516.0, "dot": 512.0,
                          "elementwise": 379540.0, "logic": 59136.0,
                          "reduce": 7292.0, "sort": 33280.0},
               "raw_cost": {"ops_control": 43.0, "ops_data_movement": 208.0,
                            "ops_dot": 2.0, "ops_elementwise": 206.0,
                            "ops_logic": 22.0, "ops_reduce": 41.0,
                            "ops_sort": 4.0}},
}


def _form(pb: ProxyBenchmark, form: str):
    if form == "eval":
        return pb.build_eval_fn(CPU), (0, pb.lifted_values(CPU))
    return pb.build_fn(CPU), (0,)


def _profile_fields(sig) -> dict:
    return {k: getattr(sig, k) for k in BEFORE["eval"]}


# -- the CPU's rule: eager, and said so --------------------------------------


def test_cpu_wall_is_eager_and_the_record_says_so():
    x = torch.arange(64, dtype=torch.float32)
    sig = signature_of_call(lambda t: t * 2.0, x, device=CPU)
    assert sig.wall_time > 0 and sig.timing == EAGER
    assert signature_of_call(lambda t: t * 2.0, x, run=False).timing == {}
    seconds, timing = timed_wall(lambda: x * 2.0, iters=3, device=CPU)
    assert seconds > 0 and timing == EAGER


def test_engine_report_and_serial_path_record_eager_timing_on_cpu():
    w = WORKLOADS["kmeans"]
    args = w.inputs(0, 0.005, device="cpu")
    session = EvalSession(run=True, seed=0, device="cpu")
    pb, rep = generate_proxy(
        w.step, *args, name="kmeans", hints=w.hints, max_iters=1,
        base_p=PVector(data_size=1 << 10, chunk_size=64, num_tasks=2,
                       batch_size=4), session=session, device="cpu")
    assert rep.real_timing == EAGER and rep.proxy_timing == EAGER
    assert session.signature_of(pb).timing == EAGER
    assert all(e.signature.timing == EAGER
               for e in session.cache._entries.values())
    (m,) = serial_evaluate_batch([pb], run=True, lifted=True, device="cpu")
    assert m["flops_rate"] > 0


# -- the profile does not move -----------------------------------------------


@pytest.mark.parametrize("form", ["eval", "static"])
def test_profile_is_unchanged_by_the_timing_change(form):
    fn, args = _form(_proxy(), form)
    assert _profile_fields(profile_call(fn, *args, device=CPU)) == \
        BEFORE[form]
    timed = signature_of_call(fn, *args, device=CPU, iters=1)
    assert _profile_fields(timed) == BEFORE[form]


# -- the generator supply, which a capture answers from ----------------------


def _draws(seed: int):
    """A function of the kind a capture takes: generators made from seeds
    and from a seed leaf."""
    gen = make_generator(seed, CPU)
    leaf = gen_seed(gen)
    a = torch.rand(5, generator=gen)
    b = torch.rand(3, generator=generator_from(leaf))
    c = torch.randint(0, 100, (4,), generator=make_generator(seed + 1, CPU))
    return a, b, c


@pytest.mark.parametrize("fn", ["draws", "proxy"])
def test_supply_answers_a_capture_with_what_the_eager_run_drew(fn):
    if fn == "draws":
        run = lambda: _draws(7)  # noqa: E731
    else:
        f, args = _form(_proxy(), "eval")
        run = lambda: f(*args)  # noqa: E731
    want = run()
    supply = GeneratorSupply(CPU)
    for _ in range(2):
        with supply.recording():
            run()
    gens = supply.prepare()
    assert len(gens) == len(supply.seeds) > 0
    for _ in range(2):  # each replay reseeds, as before a graph replay
        supply.reset()
        with supply.capturing():
            got = run()
        assert json.dumps(_leaves(got)) == json.dumps(_leaves(want))


def _leaves(tree) -> list:
    from torch.utils._pytree import tree_leaves

    return [t.view(torch.int32).tolist() if t.dtype == torch.uint32
            else t.tolist() for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def test_supply_refuses_a_run_that_asks_for_other_generators():
    supply = GeneratorSupply(CPU)
    with supply.recording():
        _draws(1)
    with pytest.raises(RuntimeError, match="generators"):
        with supply.recording():
            _draws(2)
    supply.prepare()
    with pytest.raises(RuntimeError, match="seed"):
        with supply.capturing():
            _draws(3)
    # outside a supply the calls are plain again
    assert torch.equal(_draws(1)[0], _draws(1)[0])


# -- the store: an eagerly timed entry does not answer -----------------------


def test_an_entry_timed_by_the_eager_store_version_is_a_miss(tmp_path):
    pb = ProxyBenchmark("one", (MotifNode("n0", "sort", "quick",
                                          PVector(data_size=1 << 9)),))
    first = EvalSession(run=True, seed=0, device="cpu",
                        store=ProxyStore(str(tmp_path)))
    first.evaluate(pb)
    key = first.cache.store_key(first.cache.key_for(pb))
    path = first.store._sig_path(key_digest(canonical_key(key)))
    with open(path) as f:
        doc = json.load(f)
    assert doc["version"] == STORE_VERSION == 2
    assert doc["payload"]["signature"]["timing"] == EAGER
    # the entry as the eager-timing store (version 1) wrote it
    doc["version"] = 1
    del doc["payload"]["signature"]["timing"]
    from repro_torch.core.store import _payload_checksum

    doc["checksum"] = _payload_checksum(doc["payload"])
    with open(path, "w") as f:
        json.dump(doc, f)
    second = EvalSession(run=True, seed=0, device="cpu",
                         store=ProxyStore(str(tmp_path)))
    second.evaluate(pb)
    stats = second.stats()
    assert (stats["compiles"], stats["store_hits"],
            stats["store_invalid"]) == (1, 0, 1)
    with open(path) as f:
        healed = json.load(f)
    assert healed["version"] == 2
    assert healed["payload"]["signature"]["timing"] == EAGER
    third = EvalSession(run=True, seed=0, device="cpu",
                        store=ProxyStore(str(tmp_path)))
    third.evaluate(pb)
    assert third.stats()["compiles"] == 0
    assert third.signature_of(pb).timing == EAGER

