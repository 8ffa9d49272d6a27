"""``scenario_matrix.population_bench`` times its two sides one after the
other, as the reference does in one process: rank 0's one-rank side
runs while the mesh's other ranks wait, no rank starts its share of the
sharded side before that side has ended, and then every rank runs its
share at once.  Over 2 gloo ranks on the CPU, each rank records when
each of its ``population_runtime`` and ``timed_wall`` calls starts and
ends (``time.monotonic``, one clock for every process of the host)."""
from __future__ import annotations

import time

import pytest
import torch_parity  # noqa: F401  (one torch thread a test worker)

from repro_torch.distributed.launch import spawn


def bench_spans(n: int):
    """One rank's ``population_bench`` on the dp2 mesh (built first, as
    a run has built it for its cells): ``(bench record or None, [(what,
    side, start, end)])`` of this rank's ``population_runtime`` and
    ``timed_wall`` calls."""
    import torch

    import torch_mesh_ranks as R
    from repro_torch.bench import scenario_matrix as sm
    from repro_torch.core import evaluator
    from repro_torch.core.cluster import get_scenario

    spans = []
    side = []
    run = evaluator.BatchEvaluator.population_runtime
    wall = evaluator.timed_wall

    def recorded(self, pbs, iters=3):
        side.append("single" if self.mesh is None else "sharded")
        t0 = time.monotonic()
        out = run(self, pbs, iters=iters)
        spans.append(("runtime", side[-1], t0, time.monotonic()))
        return out

    def timed(*args, **kwargs):
        t0 = time.monotonic()
        out = wall(*args, **kwargs)
        spans.append(("wall", side[-1], t0, time.monotonic()))
        return out

    evaluator.BatchEvaluator.population_runtime = recorded
    evaluator.timed_wall = timed
    scn = get_scenario("dp2")
    scn.mesh("cpu")
    rec = sm.population_bench(R.kmeans_like(), n, scn, torch.device("cpu"))
    return rec, spans


@pytest.fixture(scope="module")
def ranks():
    return spawn(bench_spans, 2, 4, timeout_s=120)


def test_sharded_side_starts_after_the_single_side(ranks):
    (rec, spans0), (rec1, spans1) = ranks
    assert rec1 is None and rec["candidates"] == 4
    assert rec["sharded_devices"] == 2 and rec["speedup"] > 0
    runs0 = [s for s in spans0 if s[0] == "runtime"]
    runs1 = [s for s in spans1 if s[0] == "runtime"]
    assert [s[1] for s in runs0] == ["single", "sharded"]
    assert [s[1] for s in runs1] == ["sharded"]
    single_end = runs0[0][3]
    starts = [runs0[1][2], runs1[0][2]]
    assert min(starts) >= single_end, (single_end, starts)

