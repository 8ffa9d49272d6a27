"""The port's Mamba-2 SSD block (``repro_torch.models.mamba2``) against
the JAX package's on the same numpy inputs and weights: the causal conv
with and without a tail, the chunked scan at lengths below, at and off
the chunk (``chunk_size`` cut to 16) with an initial state and the final
state, the block's prefill and its decode from the reference's caches,
and mamba2-780m's decode after the port's own prefill and ``pad_caches``
against the reference's teacher-forced forward.

The prefill's ``conv`` cache is the conv's input (the last rows of the
projection), not the reference's conv output (ROADMAP queue 3 item 18);
it is held to that projection as the reference computes it.

Tolerances: f32 ``F32_TOL`` (``rtol=atol=1e-4``), bf16 ``bf16_tol``
(``rtol=2^-7``, ``atol`` a tenth of the reference output's std)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (F32_TOL, as_np, block_params, flat,
                          jax_tree_to_numpy, np_rand, ref_conv_tail,
                          serve_teacher_forced, to_jax, to_torch,
                          zoo_close, zoo_pair)

import repro.configs as R
from repro.models import mamba2 as RM2
import repro_torch.configs as P
from repro_torch.convert import model_params_from_reference
from repro_torch.models import mamba2
from repro_torch.models.params import tree_map

DTYPES = ("float32", "bfloat16")
CHUNK = 16
LENGTHS = (1, 3, 255, 257, 1000)


def _cfgs(dtype: str):
    """reduced(mamba2-780m) at compute ``dtype`` with chunks of 16, in
    (the port, the reference)."""
    out = []
    for pkg in (P, R):
        cfg = pkg.reduced(pkg.get_config("mamba2-780m")).replace(dtype=dtype)
        out.append(cfg.replace(ssm=dataclasses.replace(cfg.ssm,
                                                       chunk_size=CHUNK)))
    return out


@pytest.mark.parametrize("tail", [False, True], ids=["no_tail", "tail"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv1d(dtype, tail):
    B, S, C, W = 2, 9, 24, 4
    x, w, b = (np_rand(1, (B, S, C), "float32"),
               np_rand(2, (W, C), "float32"), np_rand(3, (C,), "float32"))
    t = np_rand(4, (B, W - 1, C), "float32") if tail else None
    want = RM2.causal_conv1d(to_jax(x, dtype), to_jax(w), to_jax(b),
                             None if t is None else to_jax(t, dtype))
    got = mamba2.causal_conv1d(to_torch(x, dtype), to_torch(w), to_torch(b),
                               None if t is None else to_torch(t, dtype))
    assert got.dtype == getattr(torch, dtype)
    zoo_close(got, want, dtype)


def _scan_inputs(S: int, seed: int = 0):
    """ssd_chunked's inputs: 4 heads of 8 in 2 groups of state 8."""
    B, H, Pd, G, N = 2, 4, 8, 2, 8
    x = np_rand(seed, (B, S, H, Pd), "float32")
    dt = np.log1p(np.exp(np_rand(seed + 1, (B, S, H), "float32")))
    a_log = 0.5 * np_rand(seed + 2, (H,), "float32")
    Bm = np_rand(seed + 3, (B, S, G, N), "float32")
    Cm = np_rand(seed + 4, (B, S, G, N), "float32")
    d_skip = np_rand(seed + 5, (H,), "float32")
    init = np_rand(seed + 6, (B, H, Pd, N), "float32")
    return x, dt, a_log, Bm, Cm, d_skip, init


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", LENGTHS)
def test_ssd_chunked(S, dtype):
    """y and the final state from an initial one; inputs in ``dtype``
    (the scan itself runs in f32 in both packages)."""
    x, dt, a_log, Bm, Cm, d_skip, init = _scan_inputs(S)
    ref = jax.jit(RM2.ssd_chunked,
                  static_argnames=("chunk", "return_state"))
    wy, ws = ref(to_jax(x, dtype), to_jax(dt, dtype), to_jax(a_log),
                 to_jax(Bm, dtype), to_jax(Cm, dtype), to_jax(d_skip),
                 chunk=CHUNK, init_state=to_jax(init), return_state=True)
    gy, gs = mamba2.ssd_chunked(
        to_torch(x, dtype), to_torch(dt, dtype), to_torch(a_log),
        to_torch(Bm, dtype), to_torch(Cm, dtype), to_torch(d_skip),
        CHUNK, init_state=to_torch(init), return_state=True)
    assert gy.dtype == gs.dtype == torch.float32
    np.testing.assert_allclose(as_np(gy), as_np(wy), **F32_TOL)
    np.testing.assert_allclose(as_np(gs), as_np(ws), **F32_TOL)


def _recurrence(x, dt, a_log, Bm, Cm, d_skip, init):
    """The SSD recurrence one position at a time, in float64 numpy:
    ``state = state * exp(dt A) + dt B x^T``, ``y = C . state + D x``."""
    B, S, H, _ = x.shape
    rep = H // Bm.shape[2]
    Bh, Ch = np.repeat(Bm, rep, axis=2), np.repeat(Cm, rep, axis=2)
    A = -np.exp(a_log.astype(np.float64))
    state = init.astype(np.float64)
    ys = []
    for t in range(S):
        da = np.exp(dt[:, t] * A)                            # (B,H)
        state = state * da[..., None, None] + np.einsum(
            "bhn,bhp->bhpn", Bh[:, t] * dt[:, t, :, None], x[:, t])
        ys.append(np.einsum("bhn,bhpn->bhp", Ch[:, t], state)
                  + x[:, t] * d_skip[None, :, None])
    return np.stack(ys, axis=1), state


@pytest.mark.parametrize("S", LENGTHS)
def test_padding_adds_nothing_to_the_state(S):
    """Chunks of 16 (the last one padded where 16 does not divide S, one
    short chunk where S < 16) give the output and final state of the
    recurrence run one position at a time (float64)."""
    inputs = _scan_inputs(S, 7)
    y, state = mamba2.ssd_chunked(*map(to_torch, inputs[:6]), CHUNK,
                                  init_state=to_torch(inputs[6]),
                                  return_state=True)
    want_y, want_state = _recurrence(*inputs)
    np.testing.assert_allclose(as_np(y), want_y, **F32_TOL)
    np.testing.assert_allclose(as_np(state), want_state, **F32_TOL)


def _block(dtype: str, seed: int = 0):
    cfg, rcfg = _cfgs(dtype)
    rp, p = block_params(RM2.ssd_block_meta, rcfg, seed)
    return cfg, rcfg, rp, p


def _pre_conv_tail(rp, rcfg, x):
    """The reference block's projection before its conv, last W-1 rows,
    left-padded with zeros: what the port caches as ``conv``."""
    _, d_in, _, conv_dim = RM2._dims(rcfg)
    proj = jnp.einsum("bsd,dp->bsp", x,
                      jnp.asarray(rp["win"]).astype(jnp.dtype(rcfg.dtype)))
    return ref_conv_tail(proj[..., d_in:d_in + conv_dim],
                         rcfg.ssm.conv_width)


@pytest.mark.parametrize("S", [1, 3, 257])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_block_prefill(dtype, S):
    """The block's output and final state are the reference's; its conv
    cache is the conv's input."""
    cfg, rcfg, rp, p = _block(dtype)
    x = np_rand(11, (2, S, cfg.d_model), "float32")
    want, wc = jax.jit(lambda p_, x_: RM2.ssd_block_apply(
        p_, rcfg, x_, want_cache=True))(rp, to_jax(x, dtype))
    got, gc = mamba2.ssd_block_apply(p, cfg, to_torch(x, dtype),
                                     want_cache=True)
    zoo_close(got, want, dtype)
    zoo_close(gc["state"], wc["state"], dtype)
    assert gc["conv"].dtype == getattr(torch, dtype)
    assert tuple(gc["conv"].shape) == wc["conv"].shape
    zoo_close(gc["conv"], _pre_conv_tail(rp, rcfg, to_jax(x, dtype)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_block_decode_from_the_reference_caches(dtype):
    """One decode step from the reference's own prefill caches: the
    output and the new conv tail and state are the reference's, written
    into the cache tensors the port was given."""
    cfg, rcfg, rp, p = _block(dtype)
    x = np_rand(12, (2, 20, cfg.d_model), "float32")
    x1 = np_rand(13, (2, 1, cfg.d_model), "float32")
    _, rc = jax.jit(lambda p_, x_: RM2.ssd_block_apply(
        p_, rcfg, x_, want_cache=True))(rp, to_jax(x, dtype))
    index = np.asarray(20, np.int32)
    want, wc = jax.jit(lambda p_, c_, x_: RM2.ssd_block_apply(
        p_, rcfg, x_, cache=c_, index=jnp.asarray(index)))(
            rp, rc, to_jax(x1, dtype))
    cache = model_params_from_reference(jax_tree_to_numpy(rc), "cpu")
    given = dict(cache)
    got, gc = mamba2.ssd_block_apply(p, cfg, to_torch(x1, dtype),
                                     cache=cache,
                                     index=torch.from_numpy(index))
    zoo_close(got, want, dtype)
    for k in ("conv", "state"):
        assert gc[k] is given[k], k
        zoo_close(gc[k], wc[k], dtype, k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_serving_holds_the_reference_forward(dtype):
    """mamba2-780m (reduced: 2 layers, chunks of 32) prefills 40 tokens
    (one chunk and a padded one), pads its caches and decodes 6 tokens:
    every position's logits are the reference's teacher-forced
    forward's.  ``pad_caches`` leaves the conv tails and states as they
    are, as the reference's does."""
    rm, rp, m, p = zoo_pair("mamba2-780m", dtype)
    assert 40 % m.cfg.ssm.chunk_size and 40 > m.cfg.ssm.chunk_size
    got, want, prefilled, padded = serve_teacher_forced(
        rm, rp, m, p, batch=2, prompt=40, steps=6)
    for i, g in enumerate(got):
        zoo_close(g, want[:, i], dtype, f"position {39 + i}")
    assert flat(tree_map(lambda t: tuple(t.shape), prefilled)) == flat(
        tree_map(lambda t: tuple(t.shape), padded))
