"""The zoo's attention (``repro_torch.models.flash.flash_attention``, the
chunked online-softmax forward, and ``layers.flash_attention_reference``,
its oracle) against the JAX package's ``repro.models.flash`` and
``flash_attention_reference`` on the same numpy inputs.  f32 inputs at
``rtol=atol=1e-5``: both packages widen the operands to f32 and keep the
statistics in f32, so only the order of f32 sums differs."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_np, np_rand, to_torch

from repro.models.flash import flash_attention as ref_flash
from repro.models.layers import flash_attention_reference as ref_oracle
from repro_torch.models.flash import flash_attention, flash_forward
from repro_torch.models.layers import flash_attention_reference

TOL = dict(rtol=1e-5, atol=1e-5)

#: (B, Sq, Skv, Hq, Hkv, D) and keyword arguments
CASES = {
    "causal_gqa1": ((2, 64, 64, 4, 4, 16), dict(q_chunk=16, kv_chunk=32)),
    "not_causal_gqa4": ((1, 48, 48, 8, 2, 16),
                        dict(causal=False, q_chunk=16, kv_chunk=16)),
    "window16": ((1, 64, 64, 4, 2, 16),
                 dict(window=16, q_chunk=16, kv_chunk=16)),
    "window16_band_past_the_keys": ((1, 32, 32, 4, 2, 16),
                                    dict(window=16, q_chunk=16,
                                         kv_chunk=16)),
    "softcap50": ((2, 40, 40, 4, 1, 32),
                  dict(softcap=50.0, q_chunk=16, kv_chunk=16)),
    "q_offset": ((1, 24, 40, 8, 2, 16),
                 dict(q_offset=16, q_chunk=8, kv_chunk=16)),
    "ragged_s": ((2, 50, 50, 4, 1, 16), dict(q_chunk=16, kv_chunk=32)),
    "ragged_window_gqa4": ((1, 45, 45, 8, 2, 16),
                           dict(window=16, q_chunk=8, kv_chunk=16)),
    "default_chunks": ((2, 64, 64, 4, 2, 32), dict()),
    "p_bf16": ((1, 64, 64, 4, 2, 16),
               dict(p_bf16=True, q_chunk=16, kv_chunk=32)),
}


def _inputs(shape, seed=0):
    B, Sq, Skv, Hq, Hkv, D = shape
    return (np_rand(seed, (B, Sq, Hq, D), "float32"),
            np_rand(seed + 1, (B, Skv, Hkv, D), "float32"),
            np_rand(seed + 2, (B, Skv, Hkv, D), "float32"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_the_reference(case):
    shape, kw = CASES[case]
    q, k, v = _inputs(shape)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = flash_attention(to_torch(q), to_torch(k), to_torch(v), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL)


@pytest.mark.parametrize("case", sorted(c for c in CASES if c != "p_bf16"))
def test_flash_attention_matches_the_reference_oracle(case):
    shape, kw = CASES[case]
    q, k, v = _inputs(shape)
    want = ref_oracle(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = flash_attention(to_torch(q), to_torch(k), to_torch(v), **kw)
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL)


@pytest.mark.parametrize("case", sorted(c for c in CASES if c != "p_bf16"))
def test_the_oracle_matches_the_reference_oracle(case):
    shape, kw = CASES[case]
    q, k, v = _inputs(shape)
    want = ref_oracle(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = flash_attention_reference(to_torch(q), to_torch(k), to_torch(v),
                                    **kw)
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL)


def test_bf16_inputs_match_the_reference_to_one_rounding():
    shape, kw = CASES["window16"]
    q, k, v = _inputs(shape)
    want = ref_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), **kw)
    got = flash_attention(*(to_torch(a, "bfloat16") for a in (q, k, v)), **kw)
    assert got.dtype == torch.bfloat16
    # both round the same f32 result to bf16: one rounding apart at most
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=2.0 ** -7,
                               atol=1e-6)


def test_forward_returns_the_log_sum_exp_per_chunk():
    shape, kw = CASES["ragged_s"]
    q, k, v = _inputs(shape)
    out, lse = flash_forward(to_torch(q), to_torch(k), to_torch(v), **kw)
    B, Sq, _, Hq, Hkv, D = shape
    assert tuple(lse.shape) == (-(-Sq // 16), B, Hkv, Hq // Hkv, 16)
    # the last chunk's first row is position 48: its lse over keys 0..48
    s = np.einsum("bhd,bkhd->bhk", q[:, 48].reshape(B, Hkv, Hq // Hkv, D)[:, :, 0],
                  k[:, :49]) / np.sqrt(D)
    want = np.log(np.exp(s.astype(np.float64)).sum(-1))
    np.testing.assert_allclose(lse[-1, :, :, 0, 0].numpy(), want, rtol=1e-5)
