"""The zoo's multi-head latent attention (``repro_torch.models.layers``:
``mla_meta``, ``mla_cache_meta``, ``_mla_q``, ``_mla_ckv``, ``mla_apply``)
against the JAX package's ``repro.models.layers`` on the same numpy
inputs and weights, without q-LoRA (deepseek-v2-lite-16b) and with it
(deepseek-v3-671b): the meta trees at full and reduced width, prefill
with its latent cache, and the absorbed decode after padding the cache,
at two positions one after the other; and the shared flash attention at
MLA's widths (qk head dim 192, as many KV heads as query heads).

f32 at ``F32_TOL``; bf16 at ``bf16_tol``, the caches within one bf16
rounding where both packages round one f32 result."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (F32_TOL, ZOO_MOE, as_np, bf16_tol,
                          jax_tree_to_numpy, np_rand, to_jax, to_torch)

import repro.configs as R
from repro.models import layers as RL
from repro.models.flash import flash_attention as ref_flash
from repro.models.params import init_params as ref_init
import repro_torch.configs as P
from repro_torch.convert import model_params_from_reference
from repro_torch.models import layers as L
from repro_torch.models.flash import flash_attention

ONE_ROUNDING = dict(rtol=2.0 ** -7, atol=1e-6)
B, S = 2, 20


def _tol(dtype, want):
    return F32_TOL if dtype == "float32" else bf16_tol(want)


def _close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)


def _meta_fields(m) -> tuple:
    dtype = m.dtype if isinstance(m.dtype, torch.dtype) else np.dtype(m.dtype)
    return (m.shape, str(dtype).replace("torch.", ""), m.axes, m.init,
            m.fan_in, m.scaled_std())


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("name", ZOO_MOE)
def test_mla_meta_and_cache_meta_match_the_reference(name, size):
    cfg, rcfg = P.get_config(name), R.get_config(name)
    if size == "reduced":
        cfg, rcfg = P.reduced(cfg), R.reduced(rcfg)
    assert bool(cfg.mla.q_lora_rank) == (name == "deepseek-v3-671b")
    for got, want in ((L.mla_meta(cfg), RL.mla_meta(rcfg)),
                      (L.mla_cache_meta(cfg, 2, 64),
                       RL.mla_cache_meta(rcfg, 2, 64))):
        assert sorted(got) == sorted(want)
        for k in want:
            assert _meta_fields(got[k]) == _meta_fields(want[k]), k
    assert ("wdq" in L.mla_meta(cfg)) == bool(cfg.mla.q_lora_rank)


def _case(name: str, dtype: str, seed: int = 0):
    cfg = P.reduced(P.get_config(name)).replace(dtype=dtype)
    rcfg = R.reduced(R.get_config(name)).replace(dtype=dtype)
    rp = ref_init(jax.random.key(seed), RL.mla_meta(rcfg))
    return cfg, rcfg, rp, model_params_from_reference(jax_tree_to_numpy(rp),
                                                      "cpu")


def _x(shape, dtype, seed=5):
    a = np_rand(seed, shape, "float32")
    return to_jax(a, dtype), to_torch(a, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ZOO_MOE)
def test_mla_apply_prefill_with_cache(name, dtype):
    cfg, rcfg, rp, p = _case(name, dtype)
    jx, tx = _x((B, S, cfg.d_model), dtype)
    pos = np.arange(S, dtype=np.int32)[None]
    want, wc = RL.mla_apply(rp, rcfg, jx, positions=jnp.asarray(pos),
                            want_cache=True)
    got, gc = L.mla_apply(p, cfg, tx, positions=torch.from_numpy(pos),
                          want_cache=True)
    assert got.dtype == tx.dtype and tuple(got.shape) == tuple(want.shape)
    _close(got, want, _tol(dtype, want))
    assert sorted(gc) == ["ckv", "k_pe"]
    assert tuple(gc["ckv"].shape) == (B, S, cfg.mla.kv_lora_rank)
    assert tuple(gc["k_pe"].shape) == (B, S, cfg.mla.rope_head_dim)
    for n in gc:
        assert gc[n].dtype == getattr(torch, dtype)
        _close(gc[n], wc[n], F32_TOL if dtype == "float32" else ONE_ROUNDING)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ZOO_MOE)
def test_mla_apply_decode_after_padding_the_cache(name, dtype):
    """Prefill S tokens, pad the latent cache to S + 4 with zeros, then
    decode at positions S and S + 1, each step writing its token into the
    cache in place and attending over the positions up to it."""
    cfg, rcfg, rp, p = _case(name, dtype)
    jx, tx = _x((B, S, cfg.d_model), dtype)
    pos = np.arange(S, dtype=np.int32)[None]
    _, wc = RL.mla_apply(rp, rcfg, jx, positions=jnp.asarray(pos),
                         want_cache=True)
    _, gc = L.mla_apply(p, cfg, tx, positions=torch.from_numpy(pos),
                        want_cache=True)
    wc = {n: jnp.pad(a, ((0, 0), (0, 4), (0, 0))) for n, a in wc.items()}
    gc = {n: torch.nn.functional.pad(t, (0, 0, 0, 4)) for n, t in gc.items()}
    for step in range(2):
        idx = np.asarray(S + step, np.int32)
        jx, tx = _x((B, 1, cfg.d_model), dtype, seed=11 + step)
        want, wc = RL.mla_apply(rp, rcfg, jx, positions=jnp.asarray(idx),
                                cache=wc, index=jnp.asarray(idx))
        cache = gc
        got, gc = L.mla_apply(p, cfg, tx, positions=torch.from_numpy(idx),
                              cache=cache, index=torch.from_numpy(idx))
        assert gc["ckv"] is cache["ckv"] and gc["k_pe"] is cache["k_pe"]
        _close(got, want, _tol(dtype, want))
        for n in gc:
            _close(gc[n], wc[n],
                   F32_TOL if dtype == "float32" else ONE_ROUNDING)
        # positions past the one written stay zero
        assert not as_np(gc["ckv"][:, S + step + 1:]).any()


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_at_mla_widths(causal):
    """qk head dim 192 (128 + 64) and as many KV heads as query heads,
    v padded from 128 to 192 as ``mla_apply`` pads it."""
    q, k = (np_rand(s, (1, 40, 4, 192), "float32") for s in (1, 2))
    v = np.pad(np_rand(3, (1, 40, 4, 128), "float32"),
               ((0, 0), (0, 0), (0, 0), (0, 64)))
    kw = dict(causal=causal, q_chunk=16, kv_chunk=16)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = flash_attention(to_torch(q), to_torch(k), to_torch(v), **kw)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-5, atol=1e-5)
    assert not as_np(got[..., 128:]).any()
