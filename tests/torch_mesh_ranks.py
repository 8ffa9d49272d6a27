"""What each rank of the gloo groups in ``test_torch_cluster_mesh.py``
runs (a module of its own: a spawned rank imports it, and it imports
only ``repro_torch``, never JAX).  Every function returns plain Python
values the test holds."""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves

from repro_torch.core.cluster import (ClusterScenario, get_scenario,
                                      in_mesh, place_args, shard_args,
                                      workload_signature)
from repro_torch.core.evaluator import EvalSession, serial_evaluate_batch
from repro_torch.core.generator import generate_proxy
from repro_torch.core.motifs import PVector
from repro_torch.core.proxy_graph import _shard_batch, linear_chain
from repro_torch.distributed.sharding import use_mesh
from repro_torch.workloads import WORKLOADS

#: each workload at a scale whose batch dims divide 2 and 4 ways
SCALES = {"kmeans": 0.01, "terasort": 0.005, "pagerank": 0.02,
          "alexnet": 0.0625, "inception_v3": 0.125}
#: the tolerance of a sharded step against the whole one: f32 sums in
#: another order (the AI steps' batch-norm statistics and gradients sum
#: per rank, then across ranks), the AI steps' card-against-host
#: tolerance; integers (TeraSort) exact: ``PERF.md`` §2
STEP_TOL = dict(rtol=2e-4, atol=2e-5)

P = PVector(data_size=1 << 12, chunk_size=64, num_tasks=4, batch_size=4,
            height=8, width=8, channels=4, distribution="normal")


def kmeans_like(substrate: str = "torch"):
    """The K-means proxy's motif chain (its Table III hints)."""
    p = P.replace(substrate=substrate)
    return linear_chain("kmeans_like", [("matrix", "euclidean", p),
                                        ("statistics", "average", p),
                                        ("sort", "quick", p)])


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        return torch.allclose(a.double(), b.double(), **STEP_TOL)
    return torch.equal(a.to(torch.int64), b.to(torch.int64))


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def step_parity(mesh, names):
    """Each workload's step on ``mesh`` against the whole step: ``{name:
    (equal, collective bytes by kind of its profile)}``."""
    out = {}
    for name in names:
        w = WORKLOADS[name]
        args = w.inputs(0, SCALES[name], "cpu")
        want = tree_leaves(w.step(*args))
        placed = place_args(args, shard_args(args, w.input_axes, mesh), mesh)
        with use_mesh(mesh):
            got = [_whole(t) for t in tree_leaves(w.step(*placed))]
        sig = workload_signature(w.step, args, w.input_axes, mesh, run=False)
        out[name] = (all(_equal(a, b) for a, b in zip(got, want)),
                     dict(sig.collective_bytes))
    return out


def dp2_checks():
    """Rank of a 2-rank group: the dp2 checks of the test file."""
    mesh = get_scenario("dp2").mesh("cpu")
    res = {"rank": dist.get_rank()}
    res["steps"] = step_parity(mesh, sorted(SCALES))

    # _shard_batch: the first dim divisible by the batch quantum
    with use_mesh(mesh):
        placed = _shard_batch({"a": torch.zeros(3, 4, 8),
                               "b": torch.zeros(5), "c": torch.zeros(6, 2)})
    res["shard_batch"] = {k: (repr(tuple(v.placements))
                              if hasattr(v, "placements") else None)
                          for k, v in placed.items()}

    # the proxy's dp2 profile on both substrates (plain kernel versions)
    prof = {}
    for sub in ("torch", "hopper"):
        session = EvalSession(run=False, seed=0, device="cpu", mesh=mesh)
        sig = session.signature_of(kmeans_like(sub))
        prof[sub] = (dict(sig.collective_bytes), sig.vector(),
                     session.evaluate(kmeans_like(sub)))
    res["profiles"] = prof

    # single: the meshless engine against the serial path, bit for bit
    if dist.get_rank() == 0:
        pb = kmeans_like()
        single = EvalSession(run=False, seed=0, device="cpu",
                             mesh=get_scenario("single").mesh())
        res["single_parity"] = single.evaluate(pb) == serial_evaluate_batch(
            [pb], run=False, lifted=True, device="cpu")[0]

    # population lanes: this rank's share against the same lanes unsplit
    pb = kmeans_like()
    pop = [pb.with_node(pb.nodes[0].id, weight=float(i % 3 + 1),
                        sparsity=0.1 * (i % 2)) for i in range(5)]
    sharded = EvalSession(run=False, seed=0, device="cpu", mesh=mesh).engine
    whole = EvalSession(run=False, seed=0, device="cpu").engine
    (mine,) = list(sharded.population_chunks(pop))
    (every,) = list(whole.population_chunks(pop))
    lo, hi = sharded.lane_share(len(pop))
    got = tree_leaves(mine.runner(0)())
    want = tree_leaves(every.runner(0)())
    padded = [torch.cat([t, t[-1:].expand(hi - len(pop), *t.shape[1:])])
              if hi > len(pop) else t for t in want]
    res["population"] = (lo, hi, mine.vals.shape[0], all(
        _equal(a, b[lo:hi]) for a, b in zip(got, padded)))

    # generate_proxy under the mesh: every rank must end with one proxy
    w = WORKLOADS["kmeans"]
    target = workload_signature(w.step, w.inputs(0, SCALES["kmeans"], "cpu"),
                                w.input_axes, mesh, run=True, iters=1)
    session = EvalSession(run=True, seed=0, device="cpu", mesh=mesh,
                          wall_iters=1)
    tuned, rep = generate_proxy(
        w.step, name="kmeans@dp2", hints=w.hints, base_p=P, max_iters=2,
        target_signature=target, session=session, priors=True,
        device="cpu")
    res["tuned"] = (tuned.to_json(), rep.qualification_rate,
                    rep.prior_seeded)
    return res


def world4_checks():
    """Rank of a 4-rank group: a 2-rank mesh inside it (ranks 2 and 3
    skip its cell) and the 2-D dp2_mp2 mesh."""
    res = {"rank": dist.get_rank()}
    dp2 = get_scenario("dp2").mesh("cpu")
    grid = get_scenario("dp2_mp2").mesh("cpu")
    res["in_dp2"] = in_mesh(dp2)
    if in_mesh(dp2):
        session = EvalSession(run=True, seed=0, device="cpu", mesh=dp2,
                              wall_iters=1)
        sig = session.signature_of(kmeans_like())
        res["dp2"] = (dict(sig.collective_bytes), sig.timing)
    res["grid_steps"] = step_parity(grid, ["kmeans", "pagerank", "terasort"])
    session = EvalSession(run=False, seed=0, device="cpu", mesh=grid)
    res["grid_proxy"] = dict(session.signature_of(
        kmeans_like()).collective_bytes)
    res["bad_scenario"] = None
    try:
        ClusterScenario("big", 8, (8,)).mesh("cpu")
    except ValueError as e:
        res["bad_scenario"] = str(e)
    return res
