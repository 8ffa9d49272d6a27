"""The port's models (``repro_torch.models.build_model``) against the JAX
package's on ``reduced()`` qwen3-4b, tinyllama-1.1b, mistral-nemo-12b,
gemma2-9b (local/global ring caches, softcaps, post norms, embedding
scale), internvl2-1b (the patch-embedding stub), deepseek-v2-lite-16b and
deepseek-v3-671b (multi-head latent attention, a dense layer then an MoE
layer, q-LoRA in v3), with the reference's weights handed across:
``forward`` logits and aux loss, ``prefill`` logits and caches, and one
``decode`` from the reference's caches after ``pad_caches``.  The
DeepSeek configs run at their shipped capacity factor (1.25): the
forward's one group of 48 tokens has 16 slots an expert and drops
assignments in both packages alike.  In bf16 the MoE layer's input
differs between the packages by rounding, so a token at a near tie of
its router may choose another expert (and move the capacity drops of its
group): such tokens' logits are left out of the comparison, each flip
must lie at a near tie and at most a quarter of the tokens (or one) may
flip (``torch_parity.routing_flips``); every other row is held at the
usual tolerance.  The reference runs jitted on the CPU, one jit of each
function a config.

Tolerances: f32 ``F32_TOL`` (``rtol=atol=1e-4``; measured 4e-6 at most),
bf16 ``bf16_tol`` (``rtol=2^-7``, ``atol`` a tenth of the reference
output's standard deviation; measured 4.6 % of it at most)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (ZOO_BUILDABLE, as_np, assert_rows_close, flat,
                          jax_tree_to_numpy, record_moe_routes,
                          routing_flips, zoo_pair, zoo_tol)

from repro.runtime.serve_loop import pad_caches as ref_pad_caches
from repro_torch.convert import model_params_from_reference
from repro_torch.runtime import pad_caches

B, S, T = 2, 24, 6   # S > the reduced window (16): gemma2's ring caches
DTYPES = ("float32", "bfloat16")

_RUNS: dict = {}


def _run(name: str, dtype: str) -> dict:
    """Both packages' forward, prefill and one decode, computed once."""
    if (name, dtype) in _RUNS:
        return _RUNS[name, dtype]
    rm, rp, m, p = zoo_pair(name, dtype)
    cfg = m.cfg
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    extra = {}
    if cfg.frontend == "vision_patches":
        extra["patch_embeds"] = (rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    off = cfg.frontend_tokens if extra else 0

    def jbatch(t):
        return {"tokens": jnp.asarray(t),
                **{k: jnp.asarray(v) for k, v in extra.items()}}

    def tbatch(t):
        return {"tokens": torch.from_numpy(t),
                **{k: torch.from_numpy(v) for k, v in extra.items()}}

    out = {"cfg": cfg}
    with record_moe_routes() as routes:
        out["ref_forward"], out["ref_aux"] = jax.jit(rm.forward)(
            rp, jbatch(toks[:, :S]))
        out["forward"], out["aux"] = m.forward(p, tbatch(toks[:, :S]))
    out["forward_flips"] = routing_flips(routes["ref"], routes["port"])
    with record_moe_routes() as routes:
        out["ref_prefill"], rc = jax.jit(rm.prefill)(rp, jbatch(toks[:, :S]))
        out["prefill"], out["caches"] = m.prefill(p, tbatch(toks[:, :S]))
    out["prefill_flips"] = routing_flips(routes["ref"], routes["port"])
    out["ref_caches"] = rc
    rc = ref_pad_caches(rm, rc, B, S + off + T)
    tc = model_params_from_reference(jax_tree_to_numpy(rc), "cpu")
    out["padded"] = flat(pad_caches(m, out["caches"], B, S + off + T))
    out["ref_padded"] = flat(rc)
    idx = np.asarray(S + off, np.int32)
    with record_moe_routes() as routes:
        out["ref_decode"], rdc = jax.jit(rm.decode)(
            rp, rc, {"tokens": jnp.asarray(toks[:, S:]),
                     "index": jnp.asarray(idx)})
        out["decode"], dc = m.decode(
            p, tc, {"tokens": torch.from_numpy(toks[:, S:]),
                    "index": torch.from_numpy(idx)})
    out["decode_flips"] = routing_flips(routes["ref"], routes["port"])
    out["ref_decode_caches"], out["decode_caches"] = flat(rdc), flat(dc)
    out["decode_in_place"] = all(
        a is b for a, b in zip(flat(tc).values(), flat(dc).values()))
    _RUNS[name, dtype] = out
    return out


def _close(got, want, dtype):
    np.testing.assert_allclose(as_np(got), as_np(want), **zoo_tol(dtype, want))


def _close_logits(got, want, dtype, flips, rows):
    """Logits row by row, leaving out the tokens whose MoE routing flipped
    between the packages at a near tie (``flips``: mask and notes over the
    MoE layers' tokens, ``rows`` picks the logits' tokens from them); the
    tolerance is the whole output's."""
    mask, notes = flips
    skip = mask.reshape(rows[0])[rows[1]] if mask.size else None
    assert_rows_close(got, want, zoo_tol(dtype, want), skip, notes)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ZOO_BUILDABLE)
def test_forward(name, dtype):
    r = _run(name, dtype)
    assert tuple(r["forward"].shape) == (B, S, r["cfg"].vocab_size)
    assert r["forward"].dtype == torch.float32
    assert r["aux"].dtype == torch.float32 and r["aux"].dim() == 0
    if r["cfg"].moe is None:
        assert float(r["aux"]) == 0.0 == float(r["ref_aux"])
    else:
        assert float(r["aux"]) > 0.0
    _close(r["aux"], r["ref_aux"], dtype)
    _close_logits(r["forward"], r["ref_forward"], dtype, r["forward_flips"],
                  ((B, S), np.s_[:, :]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ZOO_BUILDABLE)
def test_prefill(name, dtype):
    r = _run(name, dtype)
    assert tuple(r["prefill"].shape) == (B, 1, r["cfg"].vocab_size)
    _close_logits(r["prefill"], r["ref_prefill"], dtype, r["prefill_flips"],
                  ((B, S), np.s_[:, -1:]))
    got, want = flat(r["caches"]), flat(jax_tree_to_numpy(r["ref_caches"]))
    assert sorted(got) == sorted(want)
    for k in want:
        assert str(got[k].dtype).replace("torch.", "") == want[k].dtype.name
        _close(got[k], want[k], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ZOO_BUILDABLE)
def test_decode_after_pad_caches(name, dtype):
    r = _run(name, dtype)
    for k, want in r["ref_padded"].items():
        assert tuple(r["padded"][k].shape) == want.shape, k
    assert tuple(r["decode"].shape) == (B, 1, r["cfg"].vocab_size)
    _close_logits(r["decode"], r["ref_decode"], dtype, r["decode_flips"],
                  ((B, 1), np.s_[:, :]))
    assert r["decode_in_place"]
    for k, want in r["ref_decode_caches"].items():
        _close(r["decode_caches"][k], want, dtype)
