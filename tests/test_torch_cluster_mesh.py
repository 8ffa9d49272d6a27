"""The cluster-scenario layer on ``torch.distributed`` against the
reference's ``repro/core/cluster.py`` and ``repro/distributed/
sharding.py``.

Pure logic (the registry, ``shrink_scenario`` and its errors,
``resolve_spec`` and the dropped-dims registry, ``quantize_proxy``, the
mesh's cache key) is held to the reference with identical outputs on the
mesh stand-ins both packages read (``conftest.QuantumMesh``/``GridMesh``:
axis names and sizes only).  Sharded execution runs in gloo groups of 2
and 4 ranks on the CPU (``repro_torch.distributed.launch.spawn``, each
group with its own rendezvous directory and time limit; what the ranks
run is ``torch_mesh_ranks.py``).
"""
from __future__ import annotations

import json

import pytest
import torch

from conftest import GridMesh, QuantumMesh

from repro.core import cluster as jcluster
from repro.core.motifs import PVector as JPVector
from repro.core.proxy_graph import MotifNode as JMotifNode
from repro.core.proxy_graph import ProxyBenchmark as JProxyBenchmark
from repro.distributed import sharding as jsharding
from repro_torch.core import cluster as tcluster
from repro_torch.core.accuracy import COLLECTIVE_KIND_FRACS
from repro_torch.core.evaluator import BatchEvaluator, ExecutableCache
from repro_torch.core.motifs import PVector
from repro_torch.core.proxy_graph import MotifNode, ProxyBenchmark
from repro_torch.distributed import sharding as tsharding
from repro_torch.distributed.launch import spawn

import torch_mesh_ranks

#: seconds a spawned group may take before it fails (a hung collective)
GROUP_TIMEOUT = 120.0

#: the reference's collective kinds per workload step on dp2 (its
#: ``workload_signature`` on emulated host devices; AlexNet's at a batch
#: the mesh divides, where the reference all-reduces 7.03e6 bytes)
REFERENCE_KINDS = {"kmeans": {"all-reduce"},
                   "terasort": {"all-gather", "all-reduce"},
                   "pagerank": {"all-reduce"}, "alexnet": {"all-reduce"},
                   "inception_v3": {"all-reduce"}}

P = dict(data_size=1 << 10, chunk_size=1 << 6, num_tasks=3, batch_size=3,
         height=8, width=8, channels=4)
MESHES = {"dp2": QuantumMesh(2), "dp4": QuantumMesh(4),
          "dp2_mp2": GridMesh({"data": 2, "model": 2}),
          "dp1_mp2": GridMesh({"data": 1, "model": 2}),
          "pod2_dp3": GridMesh({"pod": 2, "data": 3})}


# -- the registry and shrink_scenario --------------------------------------


def test_registry_is_the_reference():
    assert list(tcluster.SCENARIOS) == list(jcluster.SCENARIOS)


@pytest.mark.parametrize("name", list(jcluster.SCENARIOS))
def test_scenario_fields_are_the_reference(name):
    t, j = tcluster.get_scenario(name), jcluster.get_scenario(name)
    for f in ("name", "device_count", "mesh_shape", "axis_names",
              "data_scale", "description"):
        assert getattr(t, f) == getattr(j, f), f


def _outcome(fn, *a, **kw):
    try:
        r = fn(*a, **kw)
    except ValueError as e:  # ClusterError in both packages
        return ("raises", type(e).__name__, str(e))
    return ("ok", r.name, r.device_count, r.mesh_shape, r.axis_names,
            r.data_scale, r.description)


SHRINKS = [("dp4", 1), ("dp4", 3), ("dp4", 4), ("dp2_mp2", 1),
           ("dp2_mp2", 2), ("dp4_mp2", 2), ("dp4_mp2", 3), ("dp2", 2),
           ("dp2_2xdata", 1), ("dp8", 5), ("dp1_mp2", 1)]


@pytest.mark.parametrize("name,drop", SHRINKS)
def test_shrink_scenario_is_the_reference(name, drop):
    assert _outcome(tcluster.shrink_scenario, tcluster.get_scenario(name),
                    drop) == _outcome(jcluster.shrink_scenario,
                                      jcluster.get_scenario(name), drop)


BAD = [dict(name="x", device_count=4, mesh_shape=(3,)),
       dict(name="x", device_count=4, mesh_shape=(2, 2), axis_names=("d",)),
       dict(name="x", device_count=0), dict(name="x", device_count=2,
                                            mesh_shape=(2, 0, 1))]


@pytest.mark.parametrize("kw", BAD)
def test_bad_scenarios_raise_the_reference_error(kw):
    assert _outcome(tcluster.ClusterScenario, **kw) == \
        _outcome(jcluster.ClusterScenario, **kw)


def test_unknown_scenario_raises():
    with pytest.raises(tcluster.ClusterError, match="unknown scenario"):
        tcluster.get_scenario("no_such")


def test_single_scenario_has_no_mesh_and_a_bigger_one_needs_ranks():
    assert tcluster.get_scenario("single").mesh() is None
    # no process group counts as one rank
    with pytest.raises(tcluster.ClusterError, match="needs 2 ranks"):
        tcluster.get_scenario("dp2").mesh("cpu")


# -- resolve_spec --------------------------------------------------------------

SPECS = [((8, 4), ("batch", None)), ((6, 4), ("batch", "motif_width")),
         ((3, 4), ("batch", "motif_width")), ((12, 6), ("batch", "mlp")),
         ((4, 4), ("batch", "batch")), ((5,), ("batch",)), ((), ()),
         ((8, 3, 2), (None, "heads", "kv_seq")), ((9, 8), ("zero", None))]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", range(len(SPECS)))
def test_resolve_spec_is_the_reference(mesh, case):
    shape, axes = SPECS[case]
    m = MESHES[mesh]
    tsharding.clear_dropped()
    jsharding.clear_dropped()
    want = tuple(jsharding.resolve_spec(shape, axes, m,
                                        jsharding.ShardingRules()))
    got = tsharding.resolve_entries(shape, axes, m,
                                    tsharding.ShardingRules())
    assert got == want + (None,) * (len(shape) - len(want))
    assert tsharding.dropped_shardings() == jsharding.dropped_shardings()


def test_placements_follow_the_spec_entries():
    from torch.distributed.tensor import Replicate, Shard

    m = GridMesh({"data": 2, "model": 2})
    assert tsharding.entries_to_placements(("data", "model"), m) == (
        Shard(0), Shard(1))
    assert tsharding.entries_to_placements((None, "data"), m) == (
        Shard(1), Replicate())
    assert tsharding.resolve_spec((3, 4), ("batch", "motif_width"), m,
                                  tsharding.ShardingRules()) == (
        Replicate(), Shard(1))


def test_shard_without_a_mesh_is_the_identity():
    x = torch.arange(6)
    assert tsharding.shard(x, "batch") is x
    assert tsharding.named_sharding((6,), ("batch",)) is None


# -- quantize_proxy and the cache key ------------------------------------------


def _pb(**kw):
    return ProxyBenchmark("t", (MotifNode("n0", "sort", "",
                                          PVector(**P).replace(**kw)),))


def _jpb(**kw):
    return JProxyBenchmark("t", (JMotifNode("n0", "sort", "",
                                            JPVector(**P).replace(**kw)),))


@pytest.mark.parametrize("mesh", ["dp2", "dp2_mp2", "dp4"])
@pytest.mark.parametrize("size", [1000, 1023, 1 << 10])
def test_quantize_proxy_is_the_reference(mesh, size):
    m = MESHES[mesh]
    got = tcluster.quantize_proxy(_pb(data_size=size), m).nodes[0].p
    want = jcluster.quantize_proxy(_jpb(data_size=size), m).nodes[0].p
    assert (got.data_size, got.batch_size) == (want.data_size,
                                               want.batch_size)


@pytest.mark.parametrize("mesh", ["dp2", "dp2_mp2", "pod2_dp3"])
def test_mesh_joins_the_cache_key_as_the_reference(mesh):
    m = MESHES[mesh]
    pb = _pb()
    plain = ExecutableCache(device="cpu").key_for(pb)
    key = ExecutableCache(device="cpu", mesh=m).key_for(pb)
    assert key[:-1] == plain == pb.shape_signature()
    assert key[-1] == jcluster.mesh_structural_key(m)
    rules = tsharding.ShardingRules().with_overrides({"batch": "data"})
    ruled = ExecutableCache(device="cpu", mesh=m, rules=rules).key_for(pb)
    assert ruled[-1] == key[-1] + (("__rules__",) + rules.structural_key(),)


def test_evaluator_refuses_a_cache_of_another_mesh():
    cache = ExecutableCache(device="cpu", mesh=MESHES["dp2"])
    with pytest.raises(ValueError, match="different mesh"):
        BatchEvaluator(cache=cache, mesh=MESHES["dp4"], device="cpu")
    BatchEvaluator(cache=cache, mesh=MESHES["dp2"], device="cpu")


# -- sharded execution in gloo groups --------------------------------------


@pytest.fixture(scope="module")
def dp2_ranks(tmp_path_factory):
    return spawn(torch_mesh_ranks.dp2_checks, 2, device_type="cpu",
                 timeout_s=GROUP_TIMEOUT,
                 rdv_dir=str(tmp_path_factory.mktemp("dp2")))


@pytest.fixture(scope="module")
def world4_ranks(tmp_path_factory):
    return spawn(torch_mesh_ranks.world4_checks, 4, device_type="cpu",
                 timeout_s=GROUP_TIMEOUT,
                 rdv_dir=str(tmp_path_factory.mktemp("w4")))


@pytest.mark.parametrize("name", sorted(torch_mesh_ranks.SCALES))
def test_sharded_step_equals_the_whole_step(dp2_ranks, name):
    for r in dp2_ranks:
        assert r["steps"][name][0], (r["rank"], name)


@pytest.mark.parametrize("name", sorted(torch_mesh_ranks.SCALES))
def test_dp2_step_profile_has_the_reference_collective_kinds(dp2_ranks,
                                                             name):
    coll = dp2_ranks[0]["steps"][name][1]
    assert all(b > 0 for b in coll.values()) and coll
    assert set(coll) == REFERENCE_KINDS[name], coll
    # every rank holds the first rank's profile
    assert all(r["steps"][name][1] == coll for r in dp2_ranks)


def test_shard_batch_takes_the_first_divisible_dim(dp2_ranks):
    for r in dp2_ranks:
        assert r["shard_batch"] == {"a": "(Shard(dim=1),)", "b": None,
                                    "c": "(Shard(dim=0),)"}


def test_dp2_proxy_profile_has_reference_kinds_and_no_wait_bytes(dp2_ranks):
    coll, vec, metrics = dp2_ranks[0]["profiles"]["torch"]
    assert vec["coll_all_reduce"] > 0 and metrics["coll_frac"] > 0
    assert set(coll) <= {k for k, _ in COLLECTIVE_KIND_FRACS}
    assert not any(k in coll for k in ("wait_tensor",
                                       "_wrap_tensor_autograd"))


def test_hopper_emits_the_collectives_of_the_stock_form(dp2_ranks):
    prof = dp2_ranks[0]["profiles"]
    assert set(prof["hopper"][0]) == set(prof["torch"][0])


def test_single_is_bit_identical_to_the_serial_engine(dp2_ranks):
    assert dp2_ranks[0]["single_parity"] is True


def test_sharded_population_lanes_equal_the_whole(dp2_ranks):
    (lo0, hi0, n0, ok0), (lo1, hi1, n1, ok1) = (r["population"]
                                                for r in dp2_ranks)
    assert (lo0, hi0, lo1, hi1) == (0, 3, 3, 6) and n0 == n1 == 3
    assert ok0 and ok1


def test_every_rank_ends_generate_proxy_with_one_proxy(dp2_ranks):
    jsons = {r["tuned"][0] for r in dp2_ranks}
    assert len(jsons) == 1
    for r in dp2_ranks:
        assert r["tuned"][1] == 1.0 and r["tuned"][2] is True
    (pb_json,) = jsons
    assert all(n["p"]["num_tasks"] % 2 == 0
               for n in json.loads(pb_json)["nodes"])


def test_a_mesh_over_some_ranks_skips_the_others(world4_ranks):
    assert [r["in_dp2"] for r in world4_ranks] == [True, True, False, False]
    (c0, t0), (c1, t1) = world4_ranks[0]["dp2"], world4_ranks[1]["dp2"]
    assert c0 == c1 and c0.get("all-reduce", 0) > 0
    assert t0["mode"] == "eager" and "sharded" in t0["reason"]


@pytest.mark.parametrize("name", ["kmeans", "pagerank", "terasort"])
def test_2d_mesh_step_equals_the_whole_step(world4_ranks, name):
    for r in world4_ranks:
        ok, coll = r["grid_steps"][name]
        assert ok and coll, (r["rank"], name)


def test_2d_mesh_proxy_has_collectives(world4_ranks):
    assert all(r["grid_proxy"] == world4_ranks[0]["grid_proxy"]
               for r in world4_ranks)
    assert sum(world4_ranks[0]["grid_proxy"].values()) > 0


def test_a_scenario_bigger_than_the_group_raises(world4_ranks):
    for r in world4_ranks:
        assert "needs 8 ranks but the process group has 4" in \
            r["bad_scenario"]
