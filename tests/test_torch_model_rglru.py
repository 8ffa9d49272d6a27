"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
package's on the same numpy inputs and weights: the gates, the doubling
scan against ``lax.associative_scan`` up to 2,048 positions, the block's
prefill and its decode from the reference's caches, and
recurrentgemma-9b's decode after the port's own prefill and
``pad_caches`` (five layers: a scanned (recurrent, recurrent, local)
superblock and the unscanned (recurrent, recurrent) tail, a prompt past
the local window) against the reference's teacher-forced forward.

The prefill's ``conv`` cache is the conv's input (the last rows of
``x @ w1``), not the reference's conv output (ROADMAP queue 3 item 18).

Tolerances: f32 ``F32_TOL`` (``rtol=atol=1e-4``), bf16 ``bf16_tol``
(``rtol=2^-7``, ``atol`` a tenth of the reference output's std)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from torch_parity import (F32_TOL, as_np, block_params, flat,
                          jax_tree_to_numpy, np_rand, ref_conv_tail,
                          serve_teacher_forced, to_jax, to_torch,
                          zoo_close, zoo_pair)

import repro.configs as R
from repro.models import rglru as RG
import repro_torch.configs as P
from repro_torch.convert import model_params_from_reference
from repro_torch.models import rglru
from repro_torch.models.params import tree_map
from repro_torch.models.trunk import build_segments

DTYPES = ("float32", "bfloat16")


def _block(dtype: str, seed: int = 0):
    cfg = P.reduced(P.get_config("recurrentgemma-9b")).replace(dtype=dtype)
    rcfg = R.reduced(R.get_config("recurrentgemma-9b")).replace(dtype=dtype)
    rp, p = block_params(RG.rglru_block_meta, rcfg, seed)
    return cfg, rcfg, rp, p


def test_gates():
    cfg, rcfg, rp, p = _block("float32")
    x1 = np_rand(1, (2, 7, rglru._width(cfg)), "float32")
    want = jax.jit(RG._gates)(rp, to_jax(x1))
    got = rglru._gates(p, to_torch(x1))
    assert bool((got[0] <= 0).all())
    for g, w in zip(got, want):
        np.testing.assert_allclose(as_np(g), as_np(w), **F32_TOL)


def _combine(u, v):
    (la1, b1), (la2, b2) = u, v
    return la1 + la2, b1 * jnp.exp(la2) + b2


@pytest.mark.parametrize("S", [1, 2, 7, 300, 2048])
def test_linear_scan_matches_the_associative_scan(S):
    """The doubling scan against the reference's ``associative_scan`` of
    the same combine, on gates of the block's range (``log_a`` in
    ``[-8 softplus(1), 0]``)."""
    w = 64
    log_a = (-8.0 * np.log1p(np.e)
             / (1 + np.exp(-np_rand(2, (2, S, w), "float32")))).astype(
                 np.float32)
    b = np_rand(3, (2, S, w), "float32")
    _, want = jax.jit(lambda la, b_: lax.associative_scan(
        _combine, (la, b_), axis=1))(to_jax(log_a), to_jax(b))
    got = rglru.linear_scan(to_torch(log_a), to_torch(b))
    np.testing.assert_allclose(as_np(got), as_np(want), **F32_TOL)


def _pre_conv_tail(rp, rcfg, x):
    """The reference block's ``x @ w1`` (its conv's input), last W-1
    rows, left-padded with zeros: what the port caches as ``conv``."""
    x1 = jnp.einsum("bsd,dw->bsw", x,
                    jnp.asarray(rp["w1"]).astype(jnp.dtype(rcfg.dtype)))
    return ref_conv_tail(x1, rcfg.rglru.conv_width)


@pytest.mark.parametrize("S", [1, 3, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_block_prefill(dtype, S):
    """The block's output and last ``h`` are the reference's; its conv
    cache is the conv's input."""
    cfg, rcfg, rp, p = _block(dtype)
    x = np_rand(11, (2, S, cfg.d_model), "float32")
    want, wc = jax.jit(lambda p_, x_: RG.rglru_block_apply(
        p_, rcfg, x_, want_cache=True))(rp, to_jax(x, dtype))
    got, gc = rglru.rglru_block_apply(p, cfg, to_torch(x, dtype),
                                      want_cache=True)
    zoo_close(got, want, dtype)
    zoo_close(gc["h"], wc["h"], dtype)
    assert gc["conv"].dtype == getattr(torch, dtype)
    assert tuple(gc["conv"].shape) == wc["conv"].shape
    zoo_close(gc["conv"], _pre_conv_tail(rp, rcfg, to_jax(x, dtype)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_block_decode_from_the_reference_caches(dtype):
    """One decode step from the reference's own prefill caches: the
    output, the new conv tail and ``h`` are the reference's, written into
    the cache tensors the port was given."""
    cfg, rcfg, rp, p = _block(dtype)
    x = np_rand(12, (2, 20, cfg.d_model), "float32")
    x1 = np_rand(13, (2, 1, cfg.d_model), "float32")
    _, rc = jax.jit(lambda p_, x_: RG.rglru_block_apply(
        p_, rcfg, x_, want_cache=True))(rp, to_jax(x, dtype))
    index = np.asarray(20, np.int32)
    want, wc = jax.jit(lambda p_, c_, x_: RG.rglru_block_apply(
        p_, rcfg, x_, cache=c_, index=jnp.asarray(index)))(
            rp, rc, to_jax(x1, dtype))
    cache = model_params_from_reference(jax_tree_to_numpy(rc), "cpu")
    given = dict(cache)
    got, gc = rglru.rglru_block_apply(p, cfg, to_torch(x1, dtype),
                                      cache=cache,
                                      index=torch.from_numpy(index))
    zoo_close(got, want, dtype)
    for k in ("conv", "h"):
        assert gc[k] is given[k], k
        zoo_close(gc[k], wc[k], dtype, k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_serving_holds_the_reference_forward(dtype):
    """recurrentgemma-9b (reduced, five layers, window 16) prefills 20
    tokens, pads its caches and decodes 6 tokens: every position's logits
    are the reference's teacher-forced forward's.  ``pad_caches`` leaves
    the recurrent states and the local layers' ring caches (16 slots) as
    they are."""
    rm, rp, m, p = zoo_pair("recurrentgemma-9b", dtype, layers=5)
    assert [s.scanned for s in build_segments(m.cfg)] == [True, False]
    got, want, prefilled, padded = serve_teacher_forced(
        rm, rp, m, p, batch=2, prompt=20, steps=6)
    for i, g in enumerate(got):
        zoo_close(g, want[:, i], dtype, f"position {19 + i}")
    shapes = flat(tree_map(lambda t: tuple(t.shape), padded))
    assert shapes == flat(tree_map(lambda t: tuple(t.shape), prefilled))
    assert shapes["seg0/p2/k"] == (1, 2, m.cfg.sliding_window, 1, 32)
