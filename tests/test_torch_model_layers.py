"""The zoo's dense blocks (``repro_torch.models.layers``) against the JAX
package's ``repro.models.layers`` on the same numpy inputs and weights:
norms, qk-norm, RoPE, activations, decode attention (linear, windowed and
ring positions), the attention layer in prefill and decode, the MLP and
the embeddings.  f32 at ``F32_TOL``; bf16 within one bf16 rounding
(``rtol=2^-7``) where both packages round one f32 result, else at
``bf16_tol``."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (F32_TOL, as_np, bf16_tol, jax_tree_to_numpy,
                          np_rand, to_jax, to_torch)

import repro.configs as R
from repro.models import layers as RL
from repro.models.params import init_params as ref_init
import repro_torch.configs as P
from repro_torch.convert import model_params_from_reference
from repro_torch.models import layers as L

ONE_ROUNDING = dict(rtol=2.0 ** -7, atol=1e-6)


def _cfgs(name="qwen3-4b", **kw):
    return (P.reduced(P.get_config(name)).replace(**kw),
            R.reduced(R.get_config(name)).replace(**kw))


def _weights(ref_meta, seed=0):
    """Reference weights for a meta tree, and the same in the port."""
    rp = ref_init(jax.random.key(seed), ref_meta)
    return rp, model_params_from_reference(jax_tree_to_numpy(rp), "cpu")


def _x(shape, dtype, seed=5, scale=1.0):
    a = np_rand(seed, shape, "float32") * scale
    return to_jax(a, dtype), to_torch(a, dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)


@pytest.mark.parametrize("norm,mixed,dtype", [
    ("rmsnorm", False, "float32"), ("rmsnorm", False, "bfloat16"),
    ("layernorm", False, "float32"), ("layernorm", False, "bfloat16"),
    ("rmsnorm", True, "bfloat16"), ("layernorm", True, "bfloat16")])
def test_norm_apply(norm, mixed, dtype):
    cfg, rcfg = _cfgs(norm=norm, norm_mixed=mixed)
    rp, p = _weights(RL.norm_meta(rcfg))
    # non-trivial scale and bias
    rp = jax.tree.map(lambda a: a + 0.1 * jnp.arange(a.shape[0]) / a.shape[0],
                      rp)
    p = model_params_from_reference(jax_tree_to_numpy(rp), "cpu")
    jx, tx = _x((2, 5, cfg.d_model), dtype, scale=3.0)
    got, want = L.norm_apply(p, cfg, tx), RL.norm_apply(rp, rcfg, jx)
    assert got.dtype == tx.dtype
    _close(got, want, F32_TOL if dtype == "float32" else bf16_tol(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_head_norm(dtype):
    scale = np_rand(1, (32,), "float32")
    jx, tx = _x((2, 3, 4, 32), dtype)
    want = RL.rms_head_norm(jnp.asarray(scale), jx, 1e-6)
    got = L.rms_head_norm(to_torch(scale), tx, 1e-6)
    _close(got, want, F32_TOL if dtype == "float32" else ONE_ROUNDING)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("where", ["prefill", "decode"])
def test_rope(where, theta):
    jx, tx = _x((2, 7 if where == "prefill" else 1, 4, 32), "float32")
    if where == "prefill":
        pos = np.arange(7, dtype=np.int32)[None] + 3
    else:
        pos = np.asarray(1000, np.int32)  # a 0-d decode index
    want = RL.rope(jx, jnp.asarray(pos), theta)
    got = L.rope(tx, torch.from_numpy(pos), theta)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu_glu"])
def test_activation(act):
    cfg, rcfg = _cfgs(act=act)
    jx, tx = _x((3, 64), "float32", scale=3.0)
    _close(L.activation(cfg, tx), RL.activation(rcfg, jx), F32_TOL)


#: (index, window, positions): a linear cache, a windowed linear cache,
#: a ring cache of the window's size after wrapping
DECODE_CASES = {
    "linear": (13, None, None),
    "linear_windowed": (13, 8, None),
    "ring": (29, 8, "ring"),
    "linear_softcap": (13, None, None),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_attention(case):
    index, window, kind = DECODE_CASES[case]
    S = 8 if kind == "ring" else 20
    q = np_rand(1, (2, 1, 8, 16), "float32")
    kc, vc = (np_rand(s, (2, S, 2, 16), "float32") for s in (2, 3))
    kw = dict(window=window,
              softcap=50.0 if case.endswith("softcap") else None)
    pos = None
    if kind == "ring":
        pos = (index - np.mod(index - np.arange(S), window)).astype(np.int32)
    want = RL.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        index=jnp.asarray(index, jnp.int32),
        positions=None if pos is None else jnp.asarray(pos), **kw)
    got = L.decode_attention(
        to_torch(q), to_torch(kc), to_torch(vc),
        index=torch.tensor(index, dtype=torch.int32),
        positions=None if pos is None else torch.from_numpy(pos), **kw)
    _close(got, want, F32_TOL)


def _attn_case(name, dtype, **kw):
    cfg, rcfg = _cfgs(name, dtype=dtype, **kw)
    rp, p = _weights(RL.attn_meta(rcfg))
    return cfg, rcfg, rp, p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["global", "local"])
def test_attn_apply_prefill_with_cache(kind, dtype):
    # gemma2: softcap, window 16 (reduced); S 24 puts the local cache in
    # its ring layout
    cfg, rcfg, rp, p = _attn_case("gemma2-9b", dtype)
    S = 24
    jx, tx = _x((2, S, cfg.d_model), dtype)
    pos = np.arange(S, dtype=np.int32)[None]
    want, wc = RL.attn_apply(rp, rcfg, jx, layer_kind=kind,
                             positions=jnp.asarray(pos), want_cache=True)
    got, gc = L.attn_apply(p, cfg, tx, layer_kind=kind,
                           positions=torch.from_numpy(pos), want_cache=True)
    tol = F32_TOL if dtype == "float32" else bf16_tol(want)
    _close(got, want, tol)
    assert gc["k"].shape[1] == (16 if kind == "local" else S)
    for k in ("k", "v"):
        _close(gc[k], wc[k], F32_TOL if dtype == "float32" else bf16_tol(wc[k]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,index", [("global", 21), ("local", 21),
                                        ("local", 37)])
def test_attn_apply_decode(kind, index, dtype):
    cfg, rcfg, rp, p = _attn_case("gemma2-9b", dtype)
    S = 16 if kind == "local" else 40  # ring of the window, or linear
    cache = {n: np_rand(s, (2, S, cfg.num_kv_heads, 32), "float32") * 0.5
             for n, s in (("k", 7), ("v", 8))}
    jx, tx = _x((2, 1, cfg.d_model), dtype)
    idx = np.asarray(index, np.int32)
    want, wc = RL.attn_apply(
        rp, rcfg, jx, layer_kind=kind, positions=jnp.asarray(idx),
        cache={n: to_jax(a, dtype) for n, a in cache.items()},
        index=jnp.asarray(idx))
    tcache = {n: to_torch(a, dtype) for n, a in cache.items()}
    got, gc = L.attn_apply(p, cfg, tx, layer_kind=kind,
                           positions=torch.from_numpy(idx), cache=tcache,
                           index=torch.from_numpy(idx))
    assert gc["k"] is tcache["k"]  # written in place
    _close(got, want, F32_TOL if dtype == "float32" else bf16_tol(want))
    for n in ("k", "v"):
        _close(gc[n], wc[n], F32_TOL if dtype == "float32" else ONE_ROUNDING)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_apply(act, dtype):
    cfg, rcfg = _cfgs(act=act, dtype=dtype)
    rp, p = _weights(RL.mlp_meta(rcfg))
    assert ("wg" in p) == (act == "silu")
    jx, tx = _x((2, 6, cfg.d_model), dtype)
    want = RL.mlp_apply(rp, rcfg, jx)
    _close(L.mlp_apply(p, cfg, tx), want,
           F32_TOL if dtype == "float32" else bf16_tol(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["gemma2-9b", "tinyllama-1.1b"])
def test_embed_and_unembed(name, dtype):
    # gemma2: tied, sqrt(d) embedding scale, final softcap 30; tinyllama:
    # an untied head
    cfg, rcfg = _cfgs(name, dtype=dtype)
    rp, p = _weights(RL.embed_meta(rcfg))
    assert ("head" in p) == (not cfg.tie_embeddings)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9),
                                               dtype=np.int32)
    want = RL.embed_apply(rp, rcfg, jnp.asarray(tokens))
    got = L.embed_apply(p, cfg, torch.from_numpy(tokens))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, F32_TOL if dtype == "float32" else dict(rtol=0, atol=0))
    jx, tx = _x((2, 9, cfg.d_model), dtype)
    want = RL.unembed_apply(rp, rcfg, jx)
    got = L.unembed_apply(p, cfg, tx)
    assert got.dtype == torch.float32
    if cfg.final_softcap:
        assert float(got.abs().max()) < cfg.final_softcap
    _close(got, want, F32_TOL if dtype == "float32" else ONE_ROUNDING)
