"""The zoo attention's backward pass (``repro_torch.models.flash``'s
``flash_backward`` through the ``torch.autograd.Function`` that
``flash_attention`` applies) against ``jax.grad`` of the JAX package's
``flash_attention`` (its custom VJP, ``bwd_impl``) and against autograd
through the port's own plain ``flash_forward``, on the same numpy inputs
and cotangent.  f32 at ``rtol=atol=1e-4``: both packages widen the
operands to f32 and keep every product and statistic in f32, so only the
order of f32 sums differs (measured: 2.2e-6 at most)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_np, np_rand, to_torch

from repro.models.flash import flash_attention as ref_flash
from repro_torch.models import flash as F

TOL = dict(rtol=1e-4, atol=1e-4)

#: (B, Sq, Skv, Hq, Hkv, D) and keyword arguments: every mask, GQA,
#: ``q_offset``, lengths off the chunks and ``p_bf16``
CASES = {
    "causal": ((2, 64, 64, 4, 4, 16), dict(q_chunk=16, kv_chunk=32)),
    "causal_gqa4": ((1, 48, 48, 8, 2, 16), dict(q_chunk=16, kv_chunk=16)),
    "not_causal_skv_ne_sq": ((1, 40, 56, 8, 2, 16),
                             dict(causal=False, q_chunk=16, kv_chunk=16)),
    "window16": ((1, 64, 64, 4, 2, 16),
                 dict(window=16, q_chunk=16, kv_chunk=16)),
    "softcap50": ((2, 40, 40, 4, 1, 32),
                  dict(softcap=50.0, q_chunk=16, kv_chunk=16)),
    "window_softcap_gqa4": ((1, 45, 45, 8, 2, 16),
                            dict(window=16, softcap=5.0, q_chunk=8,
                                 kv_chunk=16)),
    "q_offset": ((1, 24, 40, 8, 2, 16),
                 dict(q_offset=16, q_chunk=8, kv_chunk=16)),
    "ragged_sq_skv": ((2, 50, 50, 4, 1, 16), dict(q_chunk=16, kv_chunk=32)),
    "default_chunks": ((2, 64, 64, 4, 2, 32), dict()),
    "p_bf16": ((1, 64, 64, 4, 2, 16),
               dict(p_bf16=True, q_chunk=16, kv_chunk=32)),
}


def _inputs(shape, seed=0):
    B, Sq, Skv, Hq, Hkv, D = shape
    return (np_rand(seed, (B, Sq, Hq, D), "float32"),
            np_rand(seed + 1, (B, Skv, Hkv, D), "float32"),
            np_rand(seed + 2, (B, Skv, Hkv, D), "float32"),
            np_rand(seed + 3, (B, Sq, Hq, D), "float32"))


def _port_grads(fn, q, k, v, dout, **kw):
    """(dq, dk, dv) of ``sum(fn(q, k, v) * dout)`` by autograd."""
    ts = [to_torch(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*ts, **kw)
    return torch.autograd.grad(out, ts, to_torch(dout))


def _ref_grads(q, k, v, dout, **kw):
    def f(q_, k_, v_):
        return jnp.sum(ref_flash(q_, k_, v_, **kw) * jnp.asarray(dout))
    return jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_the_reference_vjp(case):
    shape, kw = CASES[case]
    q, k, v, dout = _inputs(shape)
    want = _ref_grads(q, k, v, dout, **kw)
    got = _port_grads(F.flash_attention, q, k, v, dout, **kw)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(as_np(g), as_np(w), **TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", sorted(c for c in CASES if c != "p_bf16"))
def test_backward_matches_autograd_through_the_forward(case):
    # p_bf16 is left out: autograd would differentiate the bf16 rounding
    # of p, which the VJP (the reference's too) does not
    shape, kw = CASES[case]
    q, k, v, dout = _inputs(shape)
    want = _port_grads(lambda *a, **k_: F.flash_forward(*a, **k_)[0],
                       q, k, v, dout, **kw)
    got = _port_grads(F.flash_attention, q, k, v, dout, **kw)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(as_np(g), as_np(w), **TOL,
                                   err_msg=f"d{name}")


def test_bf16_backward_is_one_rounding_from_the_reference():
    shape, kw = CASES["window_softcap_gqa4"]
    q, k, v, dout = _inputs(shape)
    ts = [to_torch(a, "bfloat16").requires_grad_(True) for a in (q, k, v)]
    got = torch.autograd.grad(F.flash_attention(*ts, **kw), ts,
                              to_torch(dout, "bfloat16"))

    def f(q_, k_, v_):
        return jnp.sum(ref_flash(q_, k_, v_, **kw).astype(jnp.float32)
                       * jnp.asarray(dout, jnp.bfloat16).astype(jnp.float32))
    want = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16, name
        # both round the same f32 block sums to bf16 at the end (and ds
        # to bf16 before its products): measured, dq and dk bit-equal,
        # dv within 0.002 (one rounding; its largest entry 6.3)
        np.testing.assert_allclose(as_np(g), as_np(w), rtol=2.0 ** -7,
                                   atol=2.0 ** -8 * np.abs(as_np(w)).max(),
                                   err_msg=f"d{name}")


def test_the_function_saves_the_forward_residuals_only():
    shape, kw = CASES["ragged_sq_skv"]
    q, k, v, _ = _inputs(shape)
    ts = [to_torch(a).requires_grad_(True) for a in (q, k, v)]
    out = F.flash_attention(*ts, **kw)
    saved = out.grad_fn.saved_tensors
    out_w, lse = F.flash_forward(*(t.detach() for t in ts), **kw)
    assert len(saved) == 5
    for a, b in zip(saved, (*ts, out_w, lse)):
        assert a.shape == b.shape
    # no (Sq, Skv) score matrix among them
    assert all(t.numel() <= max(x.numel() for x in ts) for t in saved)


def test_serving_under_inference_mode_builds_no_graph():
    shape, kw = CASES["causal"]
    q, k, v, _ = _inputs(shape)
    with torch.inference_mode():
        out = F.flash_attention(to_torch(q), to_torch(k), to_torch(v), **kw)
    assert out.grad_fn is None
    np.testing.assert_allclose(
        as_np(out), as_np(F.flash_forward(to_torch(q), to_torch(k),
                                          to_torch(v), **kw)[0]), rtol=0,
        atol=0)
