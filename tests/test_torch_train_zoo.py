"""The zoo's training half against the JAX package: ``cross_entropy``
(both impls, ignored labels), and ``Model.loss`` with its gradients for
all ten configs (``reduced()``, two layers, f32, the reference's weights
handed across), held to the reference's jitted ``value_and_grad`` of its
``Model.loss``; one bf16 dense case; and ``remat`` (each layer recomputed
in the backward pass) giving the gradients it gives without.

Tolerances: f32 ``rtol=atol=1e-4`` (measured: 8e-7 of it at most, the
DeepSeek configs' MoE layers included: no router of these batches sits
at a near tie in f32); deepseek-v3-671b's bf16 weights get bf16
gradients, each its f32 gradient rounded in each package, held at
``rtol=2^-7`` (measured: one bf16 ulp at most).  bf16 (tinyllama-1.1b): the loss at one bf16
rounding (``rtol=2^-7``), each gradient at ``rtol=2^-7`` and ``atol``
0.25 x the reference gradient's standard deviation, not 0.1: the
backward's bf16 products and their roundings come in other orders in
each package (XLA fuses the two casts of a tied table, its gather
scatter-adds in bf16 where the port's gathers the f32 table), and the
reference alone, jitted against eager, differs by up to 0.17 x the std
(``embed/tokens``).  Measured, the port against the jitted reference:
0.19 x the std at most (``embed/tokens``), 0.13 elsewhere."""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (ZOO_BUILDABLE, as_np, port_loss_and_grads,
                          ref_loss_and_grads, zoo_pair, zoo_train_batch)

from repro.models.model_zoo import cross_entropy as ref_ce
from repro_torch.models import cross_entropy
from repro_torch.models.params import tree_map

F32_TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 64   # 128 tokens: whole MoE groups of 64 in the DeepSeek configs


@functools.lru_cache(maxsize=None)
def _pair(name: str, dtype: str = "float32", layers: int = 2):
    """``zoo_pair``, built once a module (the reference's init is jitted
    once a config)."""
    return zoo_pair(name, dtype, layers=layers)


def _hold(name: str, dtype: str):
    """The port's loss, metrics and gradients against the reference's."""
    rm, rp, m, p = _pair(name, dtype)
    batch = zoo_train_batch(m.cfg, 1, B, S)
    want_loss, want_m, want_g = ref_loss_and_grads(rm, rp, batch)
    got_loss, got_m, got_g = port_loss_and_grads(m, p, batch)
    assert sorted(got_g) == sorted(want_g)
    return (got_loss, got_m, got_g), (want_loss, want_m, want_g)


@pytest.mark.parametrize("name", ZOO_BUILDABLE)
def test_loss_and_grads_match_the_reference(name):
    (loss, metrics, grads), (w_loss, w_metrics, w_grads) = _hold(
        name, "float32")
    np.testing.assert_allclose(loss, w_loss, **F32_TOL)
    assert metrics["tokens"] == w_metrics["tokens"] == B * S - 3
    for k in ("ce", "aux"):
        np.testing.assert_allclose(metrics[k], w_metrics[k], **F32_TOL,
                                   err_msg=k)
    for k, w in w_grads.items():
        g = grads[k]
        assert tuple(g.shape) == w.shape, k
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), k
        # a bf16 param's gradient (deepseek-v3-671b's weights) is its f32
        # gradient rounded to bf16 in each package: one rounding apart
        tol = (F32_TOL if g.dtype == torch.float32
               else dict(rtol=2.0 ** -7, atol=1e-4))
        np.testing.assert_allclose(as_np(g), as_np(w), **tol, err_msg=k)


def test_bf16_loss_and_grads_match_the_reference():
    (loss, _, grads), (w_loss, _, w_grads) = _hold("tinyllama-1.1b",
                                                   "bfloat16")
    np.testing.assert_allclose(loss, w_loss, rtol=2.0 ** -7)
    for k, w in w_grads.items():
        w = as_np(w)
        np.testing.assert_allclose(as_np(grads[k]), w, rtol=2.0 ** -7,
                                   atol=0.25 * float(np.std(w)), err_msg=k)


@pytest.mark.parametrize("name", ["qwen3-4b", "deepseek-v2-lite-16b",
                                  "recurrentgemma-9b", "whisper-small"])
def test_remat_gives_the_same_gradients(name):
    _, _, m, p = _pair(name)
    batch = zoo_train_batch(m.cfg, 2, B, S)
    loss, _, grads = port_loss_and_grads(m, p, batch, remat=True)
    loss0, _, grads0 = port_loss_and_grads(m, p, batch, remat=False)
    assert loss == loss0
    for k in grads0:
        torch.testing.assert_close(grads[k], grads0[k], rtol=0, atol=0,
                                   msg=k)


def test_remat_recomputes_each_layer_in_the_backward():
    # with remat a layer's activations are not kept: the forward saves
    # fewer tensors for the backward pass
    _, _, m, p = _pair("tinyllama-1.1b", layers=4)
    batch = {k: torch.from_numpy(v)
             for k, v in zoo_train_batch(m.cfg, 3, B, S).items()}
    saved = {}
    for remat in (False, True):
        n = [0]

        def pack(t):
            n[0] += 1
            return t
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), p)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            m.loss(leaves, batch, remat=remat)
        saved[remat] = n[0]
    assert saved[True] < saved[False] / 2, saved


# ---------------------------------------------------------------------------
# cross entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["gather", "onehot"])
@pytest.mark.parametrize("ignored", [0, 5, 24])
def test_cross_entropy_matches_the_reference(impl, ignored):
    rng = np.random.default_rng(ignored)
    logits = (rng.standard_normal((2, 12, 37)) * 3).astype(np.float32)
    labels = rng.integers(0, 37, (2, 12)).astype(np.int32)
    labels.reshape(-1)[:ignored] = -1 - np.arange(ignored) % 3
    want, w_den = ref_ce(jnp.asarray(logits), jnp.asarray(labels), impl=impl)
    t = torch.from_numpy(logits).requires_grad_(True)
    got, den = cross_entropy(t, torch.from_numpy(labels), impl=impl)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(den) == float(w_den) == max(24 - ignored, 1)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    (g,) = torch.autograd.grad(got, t)
    if ignored == 24:  # every label ignored: a zero loss, zero gradients
        assert float(got.detach()) == 0.0 and not g.any()


def test_cross_entropy_takes_bf16_logits_in_f32():
    logits = np.random.default_rng(0).standard_normal((3, 5, 11)).astype(
        np.float32)
    labels = np.arange(15, dtype=np.int32).reshape(3, 5) % 11
    want, _ = ref_ce(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels))
    got, _ = cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                           torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
