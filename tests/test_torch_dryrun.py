"""The port's dry run (``repro_torch.launch.dryrun``) and the pieces under
it, against the JAX package.

* ``sharding_for_meta`` against the reference's on a
  ``jax.sharding.AbstractMesh`` (no devices): all ten configs' params,
  the caches of every decode cell a config runs, and the train state's
  moments with ``extra_zero=True``, on the production meshes (16, 16)
  and (2, 16, 16); every leaf's placements equal the reference's
  ``PartitionSpec``.
* ``Model.abstract(shardings=)`` on a fake world: each leaf a DTensor
  holding the reference's local shape (``NamedSharding.shard_shape``).
* The dry run of reduced configs on a fake (4, 2) world against the
  reference's ``run_cell`` over a plain ``Mesh`` of 8 host devices, in a
  subprocess (``repro.launch.dryrun`` forces 512 host devices when it is
  imported, and its ``make_production_mesh`` fails on jax 0.9, so the
  subprocess hands it the plain mesh): the same record keys, per-device
  ``dot_flops`` within ``DOT_RTOL`` (measured: at most 0.4 % apart on
  these cells, deepseek-v2-lite-16b's +0.34 %: its router and attention
  products; ``tests/torch_dot_breakdown.py`` breaks a cell down op by
  op on both sides), collective bytes on every train cell with data > 1 and
  none on a (1, 1) world, and ``roofline_terms`` equal on the same
  signature with the reference's ``HW`` set to the port's table.
* Token groups that do not divide the data axis (deepseek-v2-lite-16b
  reduced on (4, 2)): each rank computes only the ZeRO-1 part of the
  expert weights' gradients, placed as the moments are.
* The profile's own parts: ``LiveBytes``, ``shape_memo`` (the same
  profile with and without it), ``fake_world`` leaving no group behind.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
import torch.distributed as dist
import torch_parity  # noqa: F401  (one torch thread a test worker)
from jax.sharding import AbstractMesh

from repro.configs import ARCH_NAMES, ALL_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get
from repro.distributed.sharding import ShardingRules as RefRules
from repro.distributed.sharding import sharding_for_meta as ref_sfm
from repro.models import build_model as ref_build
from repro.optim import AdamWConfig as RefAdamW
from repro.runtime import TrainSettings as RefSettings
from repro.runtime import train_state_meta as ref_state_meta
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.core.signature import (LiveBytes, Signature, _Profiler,
                                        profile_abstract)
from repro_torch.distributed.launch import fake_world
from repro_torch.distributed.sharding import (MeshShape, ShardingRules,
                                              sharding_for_meta)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HW
from repro_torch.launch.train import reduce_config
from repro_torch.models import build_model
from repro_torch.models import flash
from repro_torch.models.flash import flash_forward
from repro_torch.models.params import tree_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import TrainSettings, train_state_meta

ROOT = Path(__file__).resolve().parents[1]

#: the production meshes: name -> (axis names, sizes)
MESHES = {"pod": (("data", "model"), (16, 16)),
          "multi_pod": (("pod", "data", "model"), (2, 16, 16))}

#: reduced cells the dry runs are held on: (mesh shape, arch, reduce
#: factor, cell name, seq, batch, kind)
CELLS = [((4, 2), "tinyllama-1.1b", 8, "train", 256, 8, "train"),
         ((4, 2), "tinyllama-1.1b", 8, "prefill", 256, 8, "prefill"),
         ((4, 2), "tinyllama-1.1b", 8, "decode", 256, 8, "decode"),
         ((4, 2), "qwen3-4b", 8, "train", 256, 8, "train"),
         ((1, 1), "tinyllama-1.1b", 8, "train", 256, 8, "train"),
         ((4, 2), "deepseek-v2-lite-16b", 8, "train", 256, 8, "train")]

#: per-device dot flops, port against reference (measured <= 0.4 %)
DOT_RTOL = 0.02


def _trees(name):
    """Both packages' (params, moments, caches...) ParamMeta trees of a
    config: ``[(label, ref tree, port tree, extra_zero)]``."""
    rcfg, cfg = ref_get(name), get_config(name)
    rm, m = ref_build(rcfg), build_model(cfg)
    rs = ref_state_meta(rm, RefSettings(
        optimizer=RefAdamW(moment_dtype=rcfg.opt_moment_dtype)))
    ps = train_state_meta(m, TrainSettings(
        optimizer=AdamWConfig(moment_dtype=cfg.opt_moment_dtype)))
    out = [("params", rs["params"], ps["params"], False),
           ("m", rs["opt"]["m"], ps["opt"]["m"], True),
           ("v", rs["opt"]["v"], ps["opt"]["v"], True)]
    for cell in REF_SHAPES:
        if cell.kind == "decode" and not rcfg.skipped(cell.name):
            out.append((cell.name,
                        rm.cache_meta(cell.global_batch, cell.seq_len),
                        m.cache_meta(cell.global_batch, cell.seq_len),
                        False))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_sharding_for_meta_is_the_reference_s(name, mesh):
    names, sizes = MESHES[mesh]
    ref_mesh = AbstractMesh(sizes, names)
    port_mesh = MeshShape(names, sizes)
    overrides = dict(ref_get(name).sharding_overrides)
    n = 0
    for label, rtree, ptree, zero in _trees(name):
        want = jax.tree.leaves(ref_sfm(
            rtree, ref_mesh, RefRules().with_overrides(overrides),
            extra_zero=zero))
        metas = tree_leaves(ptree)
        got = tree_leaves(sharding_for_meta(
            ptree, port_mesh, ShardingRules().with_overrides(overrides),
            extra_zero=zero))
        assert len(want) == len(got) == len(metas), label
        for w, g, m in zip(want, got, metas):
            spec = tuple(w.spec) + (None,) * (len(m.shape) - len(w.spec))
            assert g.spec(len(m.shape)) == spec, (label, m)
            n += 1
    assert n > 10
    # without a mesh every leaf is None, as in the reference
    assert all(x is None for x in tree_leaves(
        sharding_for_meta(build_model(get_config(name)).param_meta())))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ["qwen3-4b", "deepseek-v2-lite-16b",
                                  "whisper-small"])
def test_abstract_holds_the_reference_s_local_shapes(name, mesh):
    from torch.distributed.tensor import DTensor

    names, sizes = MESHES[mesh]
    ref_mesh = AbstractMesh(sizes, names)
    overrides = dict(ref_get(name).sharding_overrides)
    rpm = ref_build(ref_get(name)).param_meta()
    model = build_model(get_config(name))
    want = [(tuple(s.shard_shape(m.shape)), tuple(m.shape)) for s, m in zip(
        jax.tree.leaves(ref_sfm(rpm, ref_mesh,
                                RefRules().with_overrides(overrides))),
        jax.tree.leaves(rpm, is_leaf=lambda x: hasattr(x, "axes")))]
    with dryrun.fake_mesh(sizes, names) as m:
        got = model.abstract(sharding_for_meta(
            model.param_meta(), m, ShardingRules().with_overrides(overrides)))
        leaves = tree_leaves(got)
        assert all(isinstance(x, DTensor) and x.is_meta for x in leaves)
        assert [(tuple(x.to_local().shape), tuple(x.shape))
                for x in leaves] == want
    assert not dist.is_initialized()
    # no shardings: meta tensors of the whole shapes
    assert [tuple(x.shape) for x in tree_leaves(model.abstract())] == \
        [w[1] for w in want]


REF_PROG = r"""
import json, sys
import repro.launch.dryrun as D
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.configs.base import ShapeCell
from repro.core.signature import Signature
from repro.launch.train import reduce_config

spec = json.loads(sys.argv[1])
D.HW.update(spec["hw"])
orig = D.signature_from_compiled
sigs = []
D.signature_from_compiled = lambda c: sigs.append(orig(c)) or sigs[-1]
out = {"records": [], "roofline": []}
for dshape, arch, factor, name, seq, batch, kind in spec["cells"]:
    n = int(np.prod(dshape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(dshape),
                ("data", "model"))
    D.make_production_mesh = lambda multi_pod=False: mesh
    cfg = reduce_config(get_config(arch), factor)
    cell = ShapeCell(name, seq, batch, kind)
    D.get_config = lambda a: cfg
    D.SHAPES_BY_NAME = {name: cell}
    rec = D.run_cell(arch, name, False, verbose=False)
    rec["dot_flops"] = sigs[-1].dot_flops
    out["records"].append(rec)
    out["roofline"].append(D.roofline_terms(
        Signature(**spec["signature"]), n, cfg, cell))
print("JSON::" + json.dumps(out, default=str))
"""

#: a signature both packages' roofline arithmetic is held on
SIG = {"flops": 3.5e12, "bytes": 8.25e11, "transcendentals": 1e9,
       "collective_bytes": {"all-reduce": 2.5e9, "all-gather": 1.25e8}}


@pytest.fixture(scope="module")
def reference_run():
    spec = {"hw": HW, "cells": CELLS, "signature": SIG}
    r = subprocess.run([sys.executable, "-c", REF_PROG, json.dumps(spec)],
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": "src",
                            "JAX_PLATFORMS": "cpu"}, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("JSON::")][0]
    return json.loads(line[len("JSON::"):])


@pytest.fixture(scope="module")
def port_run():
    out = []
    for dshape, arch, factor, name, seq, batch, kind in CELLS:
        cfg = reduce_config(get_config(arch), factor)
        with dryrun.fake_mesh(dshape, ("data", "model")) as mesh:
            out.append(dryrun.cell_record(
                arch, name, cfg, ShapeCell(name, seq, batch, kind), mesh,
                verbose=False))
    assert not dist.is_initialized()
    return out


@pytest.mark.parametrize("i", range(len(CELLS)))
def test_dry_run_is_held_to_the_reference(i, reference_run, port_run):
    want, got = reference_run["records"][i], port_run[i]
    dshape, _, _, _, _, _, kind = CELLS[i]
    assert set(want) <= set(got)
    for k in ("arch", "shape", "kind", "mesh", "devices"):
        assert got[k] == want[k]
    assert got["dot_flops"] == pytest.approx(want["dot_flops"],
                                             rel=DOT_RTOL)
    coll = sum(got["collective_bytes"].values())
    if kind == "train" and dshape[0] > 1:
        assert coll > 0 and sum(want["collective_bytes"].values()) > 0
    if dshape == (1, 1):
        assert coll == 0
    assert got["peak_memory_bytes"] > 0 and got["fits_hbm"]
    assert got["dominant"] in ("compute_s", "memory_s", "collective_s")


@pytest.mark.parametrize("i", range(len(CELLS)))
def test_roofline_terms_are_the_reference_s(i, reference_run):
    dshape, arch, factor, name, seq, batch, kind = CELLS[i]
    got = dryrun.roofline_terms(
        Signature(**SIG), dshape[0] * dshape[1],
        reduce_config(get_config(arch), factor),
        ShapeCell(name, seq, batch, kind))
    want = reference_run["roofline"][i]
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == (pytest.approx(v, rel=1e-12)
                          if isinstance(v, float) else v), k


def test_run_cell_records_a_skip_and_main_an_error(tmp_path, monkeypatch):
    rec = dryrun.run_cell("qwen3-4b", "long_500k", False)
    assert set(rec) == {"arch", "shape", "skipped"}

    def boom(*a, **k):
        raise RuntimeError("no rule")

    monkeypatch.setattr(dryrun, "run_cell", boom)
    out = tmp_path / "d.json"
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "train_4k",
                        "--out", str(out)]) == 1
    (rec,) = json.loads(out.read_text())
    assert rec["multi_pod"] is False and "no rule" in rec["error"]


def test_whole_groups_take_the_zero_part_of_the_expert_gradients():
    """deepseek-v2-lite-16b reduced on a fake (4, 2) world: its 2 token
    groups do not divide the data axis of 4, so they run whole on every
    data rank, and each expert weight's gradient comes back in its
    moments' ZeRO-1 layout (split over ``data`` too), each rank's
    product for it a quarter of the whole one."""
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.params import (ParamMeta, abstract_params,
                                           tree_map)

    cfg = reduce_config(get_config("deepseek-v2-lite-16b"), 8)
    meta = L.moe_meta(cfg)
    rules = ShardingRules().with_overrides(dict(cfg.sharding_overrides))
    products = []
    with dryrun.fake_mesh((4, 2), ("data", "model")) as mesh, \
            use_mesh(mesh, rules), spmd.ReplicateUnplaceable():
        params = tree_map(lambda t: t.requires_grad_(), abstract_params(
            meta, sharding_for_meta(meta, mesh)))
        xm = ParamMeta((8, 256, cfg.d_model), getattr(torch, cfg.dtype),
                       ("batch", None, None), "zeros")
        x = abstract_params(xm, sharding_for_meta(xm, mesh))
        y, aux = L.moe_apply(params, cfg, x)
        names = ("wi", "wg", "wo")
        bmm = torch.ops.aten.bmm.default

        class Log(torch.utils._python_dispatch.TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if func is bmm:
                    products.append(tuple(out.shape))
                return out

        with Log():
            grads = torch.autograd.grad(y.float().sum() + aux,
                                        [params[k] for k in names])
    zero = sharding_for_meta(meta, MeshShape(("data", "model"), (4, 2)),
                             rules, extra_zero=True)
    for k, g in zip(names, grads):
        want = zero[k].spec(3)
        assert "data" in want and "model" == want[0], (k, want)
        got = {d: a for d, a in enumerate(want) if a}
        assert {p.dim: a for a, p in zip(("data", "model"), g.placements)
                if p.is_shard()} == got, (k, g.placements)
    E, ff, d = cfg.moe.num_experts // 2, cfg.moe.d_ff, cfg.d_model
    # the weight products: (experts, a, b), a quarter of a or b
    assert (2 * E, d // 4, ff) in products and (2 * E, ff // 4, d) in \
        products
    assert (2 * E, d, ff) not in products and (2 * E, ff, d) not in products


def test_fake_world_leaves_no_group_behind():
    with pytest.raises(ValueError):
        with fake_world(4):
            assert dist.get_world_size() == 4 and dist.get_rank() == 0
            raise ValueError("inside")
    assert not dist.is_initialized()


def test_live_bytes_counts_what_is_alive():
    live = LiveBytes()
    x = torch.empty(256, device="meta")  # 1 KiB, held before the run
    live.hold(x)
    with _Profiler(live):
        y = x * 2
        z = y + 1
        del y
        w = z.view(16, 16)  # a view adds nothing
    assert live.peak == 3 * 1024
    assert live.live == 2 * 1024
    del z, w
    assert live.live == 1024


def test_shape_memo_keeps_the_profile(monkeypatch):
    """Flash attention's forward, run three times at one shape, profiled
    once (``dryrun.MEMO``) gives the profile of running it every time,
    and the memo is gone after the run."""
    q = torch.empty(2, 256, 4, 16, device="meta")
    k = torch.empty(2, 256, 2, 16, device="meta")
    pads = []
    pad_seq = flash._pad_seq
    monkeypatch.setattr(flash, "_pad_seq",
                        lambda *a: pads.append(1) or pad_seq(*a))

    def run(q, k):
        outs = [flash.flash_forward(q, k, k, q_chunk=64, kv_chunk=64)
                for _ in range(3)]
        return outs[-1]

    every, _ = profile_abstract(run, q, k)
    runs = len(pads)
    once, _ = profile_abstract(run, q, k, memo=dryrun.MEMO)
    assert len(pads) - runs == runs // 3  # the loop ran once
    assert flash.flash_forward is flash_forward
    assert (once.flops, once.bytes, once.transcendentals, once.op_mix,
            once.raw_cost, once.peak_memory) == (
        every.flops, every.bytes, every.transcendentals, every.op_mix,
        every.raw_cost, every.peak_memory)
    assert once.peak_memory > 0
