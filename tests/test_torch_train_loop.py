"""The port's train step (``repro_torch.runtime.train_loop``) and data
pipeline (``repro_torch.data.pipeline``) against the JAX package's.

The train step: the reference's ``init_train_state`` carried across with
``convert.train_state_from_reference``, then one and three steps of the
port's ``make_train_step`` against the reference's jitted step on the
same ``synthetic_lm_batch`` batches (reduced tinyllama-1.1b, f32, remat
on as ``TrainSettings`` defaults it): params, AdamW's ``m`` and ``v``,
``step`` and every metric, with ``grad_accum=2`` (f32 sums over
microbatches) and with ``compression="ef_topk"`` (its residuals too).
f32 at ``rtol=atol=1e-4`` (measured over three steps: the metrics within
9.5e-7, the state within 1.3e-5: AdamW's first steps divide each
gradient by its own size, so an entry near zero carries the packages'
f32 difference into its update at up to the LR's size).

The pipeline: ``synthetic_lm_batch`` bit-equal to the reference's; a
``DataPipeline`` deterministic by step, from any ``start_step``, and
re-raising a producer's error on the consumer's next batch."""
from __future__ import annotations

import threading
import time

import jax
import numpy as np
import pytest
import torch

from torch_parity import as_np, flat, jax_tree_to_numpy, zoo_pair

from repro.data import synthetic_lm_batch as ref_batch
from repro.optim import AdamWConfig as RefAdamW, warmup_cosine as ref_cos
from repro.runtime import (TrainSettings as RefSettings,
                           init_train_state as ref_init,
                           make_train_step as ref_make_step)
from repro_torch.convert import train_state_from_reference
from repro_torch.data import DataPipeline, synthetic_lm_batch
from repro_torch.models.params import tree_map
from repro_torch.optim import AdamWConfig, warmup_cosine
from repro_torch.runtime import (TrainSettings, init_train_state,
                                 make_train_step, train_state_meta)
from repro_torch.runtime.train_loop import _split_microbatches

TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 4, 32


#: ef_topk's ratio: a few entries a leaf.  The compressor's choice is
#: discontinuous at its k-th largest entry, and inside the bulk of a
#: leaf's 65,536 entries neighbours lie ~1e-8 apart, under the packages'
#: f32 gradient difference (1e-7): at a ratio of 0.05, 2 of them flipped
#: (kept in one package, a residual in the other).  The largest few are
#: far apart, so the step is held whole here; the compressor itself is
#: held bit for bit on identical inputs, ties included, in
#: test_torch_optim.py.
RATIO = 1e-4


def _settings(compression: str):
    kw = dict(compression=compression, compression_ratio=RATIO)
    return (RefSettings(optimizer=RefAdamW(lr=1e-3,
                                           schedule=ref_cos(2, 10)), **kw),
            TrainSettings(optimizer=AdamWConfig(lr=1e-3,
                                                schedule=warmup_cosine(2, 10)),
                          **kw))


def _close_states(got, want):
    g, w = flat(got), flat(jax_tree_to_numpy(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert str(g[k].dtype).replace("torch.", "") == str(w[k].dtype), k
        if g[k].dtype == torch.int32:
            np.testing.assert_array_equal(as_np(g[k]), w[k], err_msg=k)
        else:
            np.testing.assert_allclose(as_np(g[k]), as_np(w[k]), **TOL,
                                       err_msg=k)


@pytest.mark.parametrize("steps,accum,compression", [
    (1, 1, "none"), (3, 1, "none"), (3, 2, "none"), (3, 1, "ef_topk")])
def test_train_steps_match_the_reference(steps, accum, compression):
    rm, _, m, _ = zoo_pair("tinyllama-1.1b", grad_accum=accum)
    r_set, p_set = _settings(compression)
    r_state = ref_init(jax.random.key(0), rm, r_set)
    state = train_state_from_reference(jax_tree_to_numpy(r_state), "cpu")
    assert ("comp" in state) == (compression == "ef_topk")
    r_step = jax.jit(ref_make_step(rm, r_set))
    p_step = make_train_step(m, p_set)
    for i in range(steps):
        b = synthetic_lm_batch(0, i, B, S, m.cfg.vocab_size)
        r_state, r_metrics = r_step(r_state, {k: jax.numpy.asarray(v)
                                              for k, v in b.items()})
        state, metrics = p_step(state, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
        _close_states(state, r_state)
        assert sorted(metrics) == sorted(r_metrics)
        for k, v in r_metrics.items():
            assert metrics[k].shape == () and not metrics[k].requires_grad
            np.testing.assert_allclose(float(metrics[k]), float(v), **TOL,
                                       err_msg=k)
    assert int(state["opt"]["step"]) == steps
    if compression == "ef_topk":  # the residuals hold all but the kept
        err = flat(state["comp"])["embed/tokens"]
        assert err.count_nonzero() > err.numel() // 2


def test_the_step_leaves_its_state_as_it_was():
    _, _, m, p = zoo_pair("tinyllama-1.1b")
    _, p_set = _settings("none")
    state = {"params": p, "opt": init_train_state(
        torch.Generator().manual_seed(0), m, p_set, device="cpu")["opt"]}
    before = tree_map(torch.clone, state)
    b = synthetic_lm_batch(0, 0, B, S, m.cfg.vocab_size)
    new, _ = make_train_step(m, p_set)(state, {k: torch.from_numpy(v)
                                               for k, v in b.items()})
    for k, t in flat(before).items():
        assert torch.equal(flat(state)[k], t), k
    assert any(not torch.equal(flat(new)[k], t)
               for k, t in flat(before).items() if k.startswith("params"))


def test_init_train_state_follows_the_meta():
    _, _, m, _ = zoo_pair("qwen3-4b")
    for comp in ("none", "ef_topk"):
        s = TrainSettings(compression=comp)
        meta = flat(train_state_meta(m, s))
        state = flat(init_train_state(torch.Generator().manual_seed(1), m, s,
                                      device="cpu"))
        assert sorted(state) == sorted(meta)
        for k, mt in meta.items():
            assert state[k].shape == mt.shape and state[k].dtype == mt.dtype
            if not k.startswith("params/"):
                assert not state[k].any(), k
        assert state["opt/step"].dtype == torch.int32


def test_split_microbatches_matches_the_reference():
    from repro.runtime.train_loop import _split_microbatches as ref_split

    x = np.arange(4 * 6 * 3, dtype=np.int32).reshape(4, 6, 3)
    got = _split_microbatches({"a": torch.from_numpy(x)}, 2)["a"]
    want = ref_split({"a": jax.numpy.asarray(x)}, 2)["a"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_train_state_from_reference_refuses_another_tree():
    with pytest.raises(ValueError):
        train_state_from_reference({"params": {}, "opt": {"m": {}}}, "cpu")
    with pytest.raises(ValueError):
        train_state_from_reference(
            {"params": {}, "opt": {"m": {}, "v": {},
                                   "step": np.zeros((), np.int64)}}, "cpu")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (3, 17), (2**31, 5)])
def test_synthetic_lm_batch_is_the_reference_stream(seed, step):
    got = synthetic_lm_batch(seed, step, 3, 20, 1000)
    want = ref_batch(seed, step, 3, 20, 1000)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in want:
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def _make(seed, step):
    return synthetic_lm_batch(seed, step, 2, 8, 50)


def test_pipeline_is_deterministic_by_step():
    pipe = DataPipeline(_make, seed=7, device="cpu")
    try:
        got = [next(pipe) for _ in range(5)]
    finally:
        pipe.close()
    assert [s for s, _ in got] == list(range(5))
    for s, b in got:
        want = _make(7, s)
        for k in want:
            assert b[k].device.type == "cpu" and b[k].dtype == torch.int32
            np.testing.assert_array_equal(b[k].numpy(), want[k])
    assert not pipe._thread.is_alive()


def test_pipeline_resumes_from_start_step():
    pipe = DataPipeline(_make, seed=7, start_step=11, prefetch=1,
                        device="cpu")
    try:
        steps = [next(pipe) for _ in range(3)]
    finally:
        pipe.close()
    assert [s for s, _ in steps] == [11, 12, 13]
    np.testing.assert_array_equal(steps[2][1]["tokens"].numpy(),
                                  _make(7, 13)["tokens"])


def test_pipeline_reraises_a_producer_error():
    def make(seed, step):
        if step == 2:
            raise RuntimeError("bad shard")
        return _make(seed, step)

    pipe = DataPipeline(make, device="cpu", prefetch=4)
    try:
        deadline = time.time() + 10
        while pipe._error is None and time.time() < deadline:
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match="bad shard"):
            for _ in range(4):
                next(pipe)
    finally:
        pipe.close()
    assert not pipe._thread.is_alive()


def test_pipeline_close_stops_a_blocked_producer():
    started = threading.Event()

    def make(seed, step):
        started.set()
        return _make(seed, step)

    pipe = DataPipeline(make, device="cpu", prefetch=1)
    assert started.wait(10)
    time.sleep(0.05)  # the producer now waits on a full queue
    pipe.close()
    assert not pipe._thread.is_alive()


def test_pipeline_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        DataPipeline(_make)
