"""Serving with the port's zoo (``repro_torch.runtime.serve_loop``):
prefill of S tokens, ``pad_caches`` to S+T, then T greedy decode steps,
each step's logits held to the teacher-forced ``forward`` over the same
tokens at that position (the decode-consistency oracle), in both
packages; ``build_model`` refusing the five configs the port cannot
build; the input specs; and a decode that reads nothing back to the
host."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torch_parity import (ZOO_BUILDABLE, ZOO_UNPORTED, as_np, flat,
                          jax_tree_to_numpy, zoo_pair, zoo_tol)

import repro.configs as R
import repro.models as RM
from repro.runtime.serve_loop import pad_caches as ref_pad_caches
import repro_torch.configs as P
from repro_torch.convert import model_params_from_reference
from repro_torch.models import Model, build_model, input_specs, make_inputs
from repro_torch.runtime import make_decode_step, make_prefill_step, pad_caches

B, S, T = 2, 20, 6


def _serve(name: str, dtype: str):
    """The port serves greedily; the reference decodes the same tokens;
    both are held to the reference's forward over all S+T tokens."""
    rm, rp, m, p = zoo_pair(name, dtype, seed=1)
    cfg = m.cfg
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = {}
    if cfg.frontend == "vision_patches":
        extra["patch_embeds"] = (rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    off = cfg.frontend_tokens if extra else 0
    textra = {k: torch.from_numpy(v) for k, v in extra.items()}

    prefill, decode = make_prefill_step(m), make_decode_step(m)
    logits, caches = prefill(p, {"tokens": torch.from_numpy(prompt), **textra})
    caches = pad_caches(m, caches, B, off + S + T)
    index = torch.tensor(off + S, dtype=torch.int32)
    steps, tokens = [logits], [prompt]
    for _ in range(T - 1):
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        tokens.append(tok.numpy())
        logits, caches = decode(p, caches, {"tokens": tok, "index": index})
        index = index + 1
        steps.append(logits)
    seq = np.concatenate(tokens, axis=1)                     # (B, S + T - 1)

    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    want, _ = jax.jit(rm.forward)(rp, {"tokens": jnp.asarray(seq), **jextra})
    own, _ = m.forward(p, {"tokens": torch.from_numpy(seq), **textra})
    rl, rc = jax.jit(rm.prefill)(rp, {"tokens": jnp.asarray(prompt), **jextra})
    rc = ref_pad_caches(rm, rc, B, off + S + T)
    ref_steps, rdec = [rl], jax.jit(rm.decode)
    for i in range(T - 1):
        rl, rc = rdec(rp, rc, {"tokens": jnp.asarray(seq[:, S + i:S + i + 1]),
                               "index": jnp.asarray(off + S + i, jnp.int32)})
        ref_steps.append(rl)
    return steps, ref_steps, want, own


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["qwen3-4b", "gemma2-9b", "internvl2-1b"])
def test_greedy_decode_matches_the_teacher_forced_forward(name, dtype):
    steps, ref_steps, want, own = _serve(name, dtype)
    for i, (got, ref) in enumerate(zip(steps, ref_steps)):
        w = as_np(want[:, S - 1 + i])
        tol = zoo_tol(dtype, w)
        # the port's step against the reference's forward ...
        np.testing.assert_allclose(as_np(got[:, 0]), w, **tol,
                                   err_msg=f"port step {i}")
        # ... against its own forward, and the reference's step against
        # the reference's forward: the oracle holds in both packages
        np.testing.assert_allclose(as_np(got[:, 0]),
                                   as_np(own[:, S - 1 + i]), **tol,
                                   err_msg=f"port step {i} vs port forward")
        np.testing.assert_allclose(as_np(ref[:, 0]), w, **tol,
                                   err_msg=f"reference step {i}")


@pytest.mark.parametrize("name", ZOO_UNPORTED)
def test_build_model_refuses_what_is_not_ported(name):
    cfg = P.get_config(name)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 5a'"):
        build_model(cfg)
    with pytest.raises(NotImplementedError):
        Model(P.reduced(cfg))


@pytest.mark.parametrize("name", ZOO_BUILDABLE)
def test_input_specs_match_the_reference(name):
    cfg, rcfg = P.get_config(name), R.get_config(name)
    for cell in R.ALL_SHAPES[:3]:
        got = flat(input_specs(cfg, P.SHAPES_BY_NAME[cell.name]))
        want = {"/".join(str(getattr(k, "key", k)) for k in path): s
                for path, s in jax.tree_util.tree_leaves_with_path(
                    RM.input_specs(rcfg, cell))}
        assert sorted(got) == sorted(want), cell.name
        for k, s in want.items():
            assert got[k].device.type == "meta"
            assert (tuple(got[k].shape),
                    str(got[k].dtype).replace("torch.", "")) == (
                        tuple(s.shape), np.dtype(s.dtype).name), (cell.name, k)


def test_make_inputs_fills_the_specs():
    cfg = P.reduced(P.get_config("internvl2-1b"))
    gen = torch.Generator().manual_seed(0)
    for cell in (P.ShapeCell("p", 64, 2, "prefill"),
                 P.ShapeCell("d", 64, 2, "decode")):
        specs = flat(input_specs(cfg, cell))
        got = flat(make_inputs(cfg, cell, gen, device="cpu"))
        assert {k: (tuple(t.shape), t.dtype) for k, t in got.items()} == {
            k: (tuple(t.shape), t.dtype) for k, t in specs.items()}
        for k, t in got.items():
            if t.dtype == torch.int32 and t.dim():
                assert 0 <= int(t.min()) and int(t.max()) < cfg.vocab_size
        if cell.kind == "decode":
            assert int(got["index"]) == 32


def test_make_inputs_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = P.reduced(P.get_config("qwen3-4b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_inputs(cfg, P.ShapeCell("p", 8, 1, "prefill"),
                    torch.Generator())


def test_pad_caches_matches_the_reference():
    rm, rp, m, p = zoo_pair("gemma2-9b", "bfloat16")
    toks = np.arange(B * S, dtype=np.int32).reshape(B, S) % 512
    _, rc = jax.jit(rm.prefill)(rp, {"tokens": jnp.asarray(toks)})
    tc = model_params_from_reference(jax_tree_to_numpy(rc), "cpu")
    want = flat(jax_tree_to_numpy(ref_pad_caches(rm, rc, B, 48)))
    got = flat(pad_caches(m, tc, B, 48))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(as_np(got[k]), w.astype(np.float32))
    with pytest.raises(ValueError, match="larger"):
        pad_caches(m, tc, B, 8)


class _HostReads(TorchDispatchMode):
    """Records every op that copies a tensor's value to the host."""

    READS = ("_local_scalar_dense", "item", "nonzero", "masked_select")

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.READS:
            self.reads.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["gemma2-9b", "internvl2-1b"])
def test_decode_reads_nothing_back_to_the_host(name):
    cfg = P.reduced(P.get_config(name))
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = make_inputs(cfg, P.ShapeCell("d", 40, 2, "decode"), gen, m,
                        device="cpu")
    step = make_decode_step(m)
    with _HostReads() as mode:
        for _ in range(2):
            logits, caches = step(p, batch["caches"],
                                  {"tokens": batch["tokens"],
                                   "index": batch["index"]})
            batch["index"] = batch["index"] + 1
    assert mode.reads == []
    assert torch.isfinite(logits).all()
