"""The port's models (``repro_torch.models.build_model``) against the JAX
package's on ``reduced()`` qwen3-4b, tinyllama-1.1b, mistral-nemo-12b,
gemma2-9b (local/global ring caches, softcaps, post norms, embedding
scale) and internvl2-1b (the patch-embedding stub), with the reference's
weights handed across: ``forward`` logits, ``prefill`` logits and caches,
and one ``decode`` from the reference's caches after ``pad_caches``.  The
reference runs jitted on the CPU, one jit of each function a config.

Tolerances: f32 ``F32_TOL`` (``rtol=atol=1e-4``; measured 4e-6 at most),
bf16 ``bf16_tol`` (``rtol=2^-7``, ``atol`` a tenth of the reference
output's standard deviation; measured 4.6 % of it at most)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (ZOO_BUILDABLE, as_np, flat, jax_tree_to_numpy,
                          zoo_pair, zoo_tol)

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
    out["ref_forward"], _ = jax.jit(rm.forward)(rp, jbatch(toks[:, :S]))
    out["forward"], aux = m.forward(p, tbatch(toks[:, :S]))
    out["aux"] = aux
    out["ref_prefill"], rc = jax.jit(rm.prefill)(rp, jbatch(toks[:, :S]))
    out["prefill"], out["caches"] = m.prefill(p, tbatch(toks[:, :S]))
    out["ref_caches"] = rc
    rc = ref_pad_caches(rm, rc, B, S + off + T)
    tc = model_params_from_reference(jax_tree_to_numpy(rc), "cpu")
    out["padded"] = flat(pad_caches(m, out["caches"], B, S + off + T))
    out["ref_padded"] = flat(rc)
    idx = np.asarray(S + off, np.int32)
    out["ref_decode"], rdc = jax.jit(rm.decode)(
        rp, rc, {"tokens": jnp.asarray(toks[:, S:]), "index": jnp.asarray(idx)})
    out["decode"], dc = m.decode(
        p, tc, {"tokens": torch.from_numpy(toks[:, S:]),
                "index": torch.from_numpy(idx)})
    out["ref_decode_caches"], out["decode_caches"] = flat(rdc), flat(dc)
    out["decode_in_place"] = all(
        a is b for a, b in zip(flat(tc).values(), flat(dc).values()))
    _RUNS[name, dtype] = out
    return out


def _close(got, want, dtype):
    np.testing.assert_allclose(as_np(got), as_np(want), **zoo_tol(dtype, want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ZOO_BUILDABLE)
def test_forward(name, dtype):
    r = _run(name, dtype)
    assert tuple(r["forward"].shape) == (B, S, r["cfg"].vocab_size)
    assert r["forward"].dtype == torch.float32
    assert float(r["aux"]) == 0.0
    _close(r["forward"], r["ref_forward"], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ZOO_BUILDABLE)
def test_prefill(name, dtype):
    r = _run(name, dtype)
    assert tuple(r["prefill"].shape) == (B, 1, r["cfg"].vocab_size)
    _close(r["prefill"], r["ref_prefill"], dtype)
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
    _close(r["decode"], r["ref_decode"], dtype)
    assert r["decode_in_place"]
    for k, want in r["ref_decode_caches"].items():
        _close(r["decode_caches"][k], want, dtype)
