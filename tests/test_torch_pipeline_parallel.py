"""The port's GPipe ``pipeline_apply`` against the reference's
``repro/distributed/pipeline_parallel.py``, and the port's checkpoints
on a mesh.

The multi-stage pipeline runs in one gloo group of two ranks on the CPU
(``repro_torch.distributed.launch.spawn``; what the ranks run is
``repro_torch.bench.stress_group``), the reference's in one subprocess with four
emulated devices over a plain ``jax.sharding.Mesh`` (``jax.make_mesh``
gives explicit-sharding axes on jax 0.9, where the reference's final
slice raises); both are held to ``gpipe_reference`` at the reference
test's ``rtol=atol=1e-5``.  The same group saves a dp2-sharded state and
restores it onto dp2 and onto one rank (the elastic restart), and runs a
``FaultTolerantRunner`` on a sharded state.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.distributed import pipeline_parallel as jpp
from repro_torch.distributed import pipeline_parallel as tpp
from repro_torch.bench import stress_group
from repro_torch.distributed.launch import spawn

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
#: seconds the gloo group may take before it fails (a hung collective)
GROUP_TIMEOUT = 120.0
#: microbatches, rows, width: the reference test's shape
NUM_MB, MB, D = 8, 2, 16


def _inputs(stages: int, seed: int = 0):
    g = np.random.default_rng(seed)
    w = (g.standard_normal((stages, D, D)) * 0.3).astype(np.float32)
    b = g.standard_normal((stages, 1, D)).astype(np.float32)
    x = g.standard_normal((NUM_MB, MB, D)).astype(np.float32)
    return w, b, x


def _jax_stage(w, h):
    return jnp.tanh(h @ w)


#: the reference's pipeline over the first ``stages`` of four emulated
#: devices, on a plain ``Mesh``, for 2 and 4 stages
JAX_PROG = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.distributed.pipeline_parallel import pipeline_apply

    out = {}
    for stages in (2, 4):
        inp = np.load(sys.argv[1] + f"/in{stages}.npz")
        mesh = Mesh(np.asarray(jax.devices()[:stages], dtype=object),
                    ("pipe",))
        out[f"pipe{stages}"] = np.asarray(pipeline_apply(
            lambda w, h: jnp.tanh(h @ w), jnp.asarray(inp["w"]),
            jnp.asarray(inp["x"]), mesh, axis="pipe"))
    np.savez(sys.argv[1] + "/out.npz", **out)
    print("OK")
""")


@pytest.fixture(scope="module")
def jax_pipelines(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpipe")
    for stages in (2, 4):
        w, _, x = _inputs(stages)
        np.savez(d / f"in{stages}.npz", w=w, x=x)
    r = subprocess.run([sys.executable, "-c", JAX_PROG, str(d)],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": "src"}, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    return dict(np.load(d / "out.npz"))


#: the elastic-restore state's placements on dp2
SPLIT = {"w": (Shard(0),), "count": (Replicate(),), "v": (Shard(0),),
         "flags": (Shard(0),)}


def _state() -> dict:
    """f32, int64, bf16 and bool leaves, from a seed."""
    g = np.random.default_rng(7)
    return {"w": torch.from_numpy(g.standard_normal((64, 8)).astype(
                np.float32)),
            "count": torch.tensor(2**40 + 3, dtype=torch.int64),
            "v": torch.from_numpy(g.standard_normal(16).astype(
                np.float32)).to(torch.bfloat16),
            "flags": torch.tensor([True, False, False, True])}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    w, b, x = _inputs(2)
    return spawn(stress_group.pipeline_and_restore, 2, "cpu", w, b, x,
                 _state(), SPLIT, "dp2", str(tmp_path_factory.mktemp("ckpt")),
                 device_type="cpu", timeout_s=GROUP_TIMEOUT,
                 rdv_dir=str(tmp_path_factory.mktemp("rdv")))


def test_gpipe_matches_reference(group, jax_pipelines):
    """Two stages in a gloo group against the reference's pipeline on two
    emulated devices, both against the sequential oracles of the two
    packages."""
    w, _, x = _inputs(2)
    want = np.asarray(jpp.gpipe_reference(_jax_stage, jnp.asarray(w),
                                          jnp.asarray(x)))
    port_ref = tpp.gpipe_reference(stress_group.stage_fn,
                                   torch.from_numpy(w),
                                   torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(port_ref, want, **TOL)
    np.testing.assert_allclose(jax_pipelines["pipe2"], want, **TOL)
    for r in group:  # every rank holds the result
        np.testing.assert_allclose(r["pipe"], want, **TOL)
        np.testing.assert_allclose(r["pipe"], jax_pipelines["pipe2"], **TOL)
        assert r["pipe_err"] <= TOL["atol"]  # the rank's own oracle


def test_four_stage_reference_matches_the_ports_oracle(jax_pipelines):
    """The reference test's four stages: its pipeline on a plain mesh
    against the port's sequential oracle on the same inputs."""
    w, _, x = _inputs(4)
    got = tpp.gpipe_reference(stress_group.stage_fn,
                              torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_allclose(jax_pipelines["pipe4"], got.numpy(), **TOL)


def test_pipeline_takes_a_tree_of_stage_params(group):
    w, b, x = _inputs(2)
    want = tpp.gpipe_reference(
        stress_group.tree_stage_fn,
        {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
        torch.from_numpy(x)).numpy()
    for r in group:
        np.testing.assert_allclose(r["pipe_tree"], want, **TOL)
        assert r["pipe_tree_err"] <= TOL["atol"]


def test_single_stage_degenerate_matches_reference():
    """A 1-stage pipe (no mesh, no group): the rotation schedule collapses
    to a plain map and must agree with the reference's 1-device pipe and
    both oracles."""
    g = np.random.default_rng(1)
    w = (g.standard_normal((1, 8, 8)) * 0.3).astype(np.float32)
    x = g.standard_normal((2, 2, 8)).astype(np.float32)
    mesh = jax.make_mesh((1,), ("pipe",))
    jgot = np.asarray(jpp.pipeline_apply(_jax_stage, jnp.asarray(w),
                                         jnp.asarray(x), mesh, axis="pipe"))
    tgot = tpp.pipeline_apply(stress_group.stage_fn,
                              torch.from_numpy(w), torch.from_numpy(x), None)
    np.testing.assert_allclose(tgot.numpy(), jgot, **TOL)
    np.testing.assert_allclose(
        tgot.numpy(), tpp.gpipe_reference(stress_group.stage_fn,
                                          torch.from_numpy(w),
                                          torch.from_numpy(x)).numpy(),
        **TOL)


def test_pipeline_refuses_a_mesh_without_the_axis():
    class TwoD:
        mesh_dim_names = ("data", "model")

    with pytest.raises(ValueError, match="1-D mesh over 'pipe'"):
        tpp.pipeline_apply(stress_group.stage_fn, torch.zeros(1, 2, 2),
                           torch.zeros(1, 1, 2), TwoD())


@pytest.mark.parametrize("check", ["dp2_dtensors", "dp2_local", "dp2_whole",
                                   "like_protos", "one_rank"])
def test_elastic_restore_across_meshes(group, check):
    """A state sharded on dp2 (f32, int64, bf16 and bool leaves), saved
    asynchronously, restores exactly onto dp2 by ``shardings`` and by its
    DTensor prototypes, and onto one rank."""
    for r in group:
        assert r["restore"]["step"] == stress_group.SAVE_STEP
        assert r["restore"][check], (r["rank"], check)


def test_runner_on_a_sharded_state(group):
    """One injected fault at step 2 restores the dp2-sharded state from
    its step-1 checkpoint; the run ends with every update applied once."""
    for r in group:
        run = r["runner"]
        assert run["final_step"] == 5 and run["recoveries"] == 1
        assert run["sharded"]
        np.testing.assert_array_equal(run["w"], np.full(8, 5.0, np.float32))
        assert run["losses"] == [8.0, 16.0, 24.0, 32.0, 40.0]
