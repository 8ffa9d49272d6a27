"""The port's Whisper encoder-decoder (``repro_torch.models.whisper`` and
``layers.cross_attn_*``) against the JAX package's on the same numpy
inputs and weights: the encoder, cross attention's K/V and its apply
(with and without qk-norm), the decoder stack's prefill and its decode
from the reference's caches, ``pad_caches`` (the reference's padded self
caches, the cross K/V left at the memory's length), and whisper-small's
decode after the port's own prefill and ``pad_caches`` against the
reference's teacher-forced forward.

The reference's ``pad_caches`` pads the cross K/V with zero keys that
cross attention does not mask (ROADMAP queue 3 item 18); the port's
leaves them as the prefill made them.

Tolerances: f32 ``F32_TOL`` (``rtol=atol=1e-4``), bf16 ``bf16_tol``
(``rtol=2^-7``, ``atol`` a tenth of the reference output's std)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (block_params, flat, jax_tree_to_numpy, np_rand,
                          serve_teacher_forced, to_jax, to_torch, zoo_close,
                          zoo_pair)

import repro.configs as R
from repro.models import build_model as ref_build
from repro.models import layers as RL, whisper as RW
from repro.runtime.serve_loop import pad_caches as ref_pad_caches
import repro_torch.configs as P
from repro_torch.convert import model_params_from_reference
from repro_torch.models import build_model, layers as L, whisper
from repro_torch.runtime import pad_caches

DTYPES = ("float32", "bfloat16")
B, S, S_ENC = 2, 12, 10


def _cfgs(dtype: str, **over):
    return tuple(pkg.reduced(pkg.get_config("whisper-small")).replace(
        dtype=dtype, **over) for pkg in (P, R))


def _frames(dtype: str):
    f = 0.02 * np_rand(1, (B, S_ENC, 128), "float32")
    return to_jax(f, dtype), to_torch(f, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode(dtype):
    cfg, rcfg = _cfgs(dtype)
    rp, p = block_params(RW.whisper_meta, rcfg)
    jf, tf = _frames(dtype)
    want = jax.jit(lambda p_, f_: RW.encode(p_, rcfg, f_))(rp, jf)
    got = whisper.encode(p, cfg, tf)
    assert got.dtype == getattr(torch, dtype)
    zoo_close(got, want, dtype)


@pytest.mark.parametrize("qk_norm", [False, True],
                         ids=["plain", "qk_norm"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention(dtype, qk_norm):
    """``cross_attn_kv`` of an encoder memory, then ``cross_attn_apply``
    of 7 decoder positions against it (no mask: every memory position
    visible)."""
    cfg, rcfg = _cfgs(dtype, qk_norm=qk_norm)
    rp, p = block_params(RL.attn_meta, rcfg)
    mem = np_rand(2, (B, S_ENC, 128), "float32")
    x = np_rand(3, (B, 7, 128), "float32")
    wk, wv = jax.jit(lambda p_, m_: RL.cross_attn_kv(p_, rcfg, m_))(
        rp, to_jax(mem, dtype))
    gk, gv = L.cross_attn_kv(p, cfg, to_torch(mem, dtype))
    zoo_close(gk, wk, dtype, "k")
    zoo_close(gv, wv, dtype, "v")
    want = jax.jit(lambda p_, x_, kv: RL.cross_attn_apply(p_, rcfg, x_, kv))(
        rp, to_jax(x, dtype), (wk, wv))
    kv = tuple(model_params_from_reference({"k": np.asarray(wk),
                                            "v": np.asarray(wv)},
                                           "cpu").values())
    got = L.cross_attn_apply(p, cfg, to_torch(x, dtype), kv)
    zoo_close(got, want, dtype)


def _prefill_pair(dtype: str):
    """Both decoder stacks' prefill of S tokens against the reference's
    encoder memory: (cfgs, params, tokens, reference (x, caches), port
    (x, caches))."""
    cfg, rcfg = _cfgs(dtype)
    rp, p = block_params(RW.whisper_meta, rcfg)
    jf, _ = _frames(dtype)
    memory = jax.jit(lambda p_, f_: RW.encode(p_, rcfg, f_))(rp, jf)
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    want = jax.jit(lambda p_, t_, m_: RW.decode_stack(
        p_, rcfg, t_, memory=m_, want_cache=True))(
            rp, jnp.asarray(tokens), memory)
    got = whisper.decode_stack(
        p, cfg, torch.from_numpy(tokens),
        memory=model_params_from_reference(
            {"m": np.asarray(memory)}, "cpu")["m"], want_cache=True)
    return (cfg, rcfg), (rp, p), tokens, want, got


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_stack_prefill(dtype):
    *_, (wx, wc), (gx, gc) = _prefill_pair(dtype)
    zoo_close(gx, wx, dtype)
    want, got = flat(jax_tree_to_numpy(wc)), flat(gc)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        zoo_close(got[k], want[k], dtype, k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_stack_decode_from_the_reference_caches(dtype):
    """Two decode steps from the reference's prefill caches after its
    ``pad_caches`` (its zero cross keys included, which both packages
    then attend to alike): each step's output and the caches are the
    reference's, written into the cache tensors the port was given."""
    (cfg, rcfg), (rp, p), _, (_, wc), _ = _prefill_pair(dtype)
    wc = ref_pad_caches(ref_build(rcfg), wc, B, 2 * S_ENC + 6)
    gc = model_params_from_reference(jax_tree_to_numpy(wc), "cpu")
    given = flat(gc)
    step = jax.jit(lambda p_, c_, t_, i_: RW.decode_stack(
        p_, rcfg, t_, caches=c_, index=i_))
    for i, tok in enumerate(np.asarray([[[5], [9]], [[7], [3]]], np.int32)):
        index = np.asarray(S + i, np.int32)
        wx, wc = step(rp, wc, jnp.asarray(tok), jnp.asarray(index))
        gx, gc = whisper.decode_stack(p, cfg, torch.from_numpy(tok),
                                      caches=gc,
                                      index=torch.from_numpy(index))
        zoo_close(gx, wx, dtype, f"step {i}")
    assert all(a is given[k] for k, a in flat(gc).items())
    for k, w in flat(jax_tree_to_numpy(wc)).items():
        zoo_close(flat(gc)[k], w, dtype, k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pad_caches_keeps_the_cross_caches(dtype):
    """The port's ``pad_caches`` of its prefill caches gives the
    reference's padded self caches, and cross K/V at the memory's length
    (the reference pads them to ``target // 2`` with zeros)."""
    (cfg, rcfg), _, _, (_, wc), (_, gc) = _prefill_pair(dtype)
    target = 2 * S_ENC + 6                   # the reference's cross: 13
    want = flat(jax_tree_to_numpy(ref_pad_caches(ref_build(rcfg), wc, B,
                                                 target)))
    got = flat(pad_caches(build_model(cfg), gc, B, target))
    prefilled = flat(gc)
    assert sorted(got) == sorted(want)
    for k in want:
        if k.startswith("cross/"):
            assert want[k].shape[2] == target // 2 > S_ENC
            assert got[k] is prefilled[k], k
        else:
            assert tuple(got[k].shape) == want[k].shape, k
            zoo_close(got[k], want[k], dtype, k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_serving_holds_the_reference_forward(dtype):
    """whisper-small (reduced: 2 + 2 layers) encodes 10 frames,
    prefills 20 tokens, pads its caches and decodes 6 tokens: every
    position's logits are the reference's teacher-forced forward's."""
    rm, rp, m, p = zoo_pair("whisper-small", dtype)
    got, want, prefilled, padded = serve_teacher_forced(
        rm, rp, m, p, batch=B, prompt=20, steps=6)
    for i, g in enumerate(got):
        zoo_close(g, want[:, i], dtype, f"position {19 + i}")
    assert tuple(padded["cross"]["k"].shape) == (2, B, 10, 4, 32)
    assert tuple(padded["self"]["k"].shape) == (2, B, 26, 4, 32)
