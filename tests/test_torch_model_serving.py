"""Serving with the port's zoo (``repro_torch.runtime.serve_loop``):
prefill of S tokens, ``pad_caches`` to S+T, then T greedy decode steps,
each step's logits held to the teacher-forced ``forward`` over the same
tokens at that position (the decode-consistency oracle), in both
packages; ``build_model`` refusing the three configs the port cannot
build; the input specs; and a decode that reads nothing back to the
host.

The oracle needs the MoE layers to drop nothing.  A forward group of Tg
tokens has ``_capacity(mo, Tg)`` slots an expert and drops the overflow,
a decode step's group of B tokens never does, and the prefill that fills
the caches may: in either package, by the reference's own semantics.  So
the DeepSeek configs serve here at ``no_drop_capacity`` (asserted:
``_capacity(mo, Tg) >= Tg`` for every group the run forms); the shipped
capacity, drops included, is held against the reference in
``test_torch_model_zoo.py``.  In bf16 a decode step's MoE input differs
by rounding from the forward's at the same position, so a token at a
near tie of its router may choose another expert: such rows are left out
of the comparison and each flip must lie at a near tie
(``torch_parity.routing_flips``)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torch_parity import (ZOO_BUILDABLE, ZOO_MOE, ZOO_UNPORTED, as_np,
                          assert_rows_close, flat, jax_tree_to_numpy,
                          record_moe_routes, routing_flips, zoo_pair,
                          zoo_tol)

import repro.configs as R
import repro.models as RM
from repro.runtime.serve_loop import pad_caches as ref_pad_caches
import repro_torch.configs as P
from repro_torch.convert import model_params_from_reference
from repro_torch.models import Model, build_model, input_specs, make_inputs
from repro_torch.models.layers import _capacity
from repro_torch.runtime import make_decode_step, make_prefill_step, pad_caches

B, S, T = 2, 20, 6


def _serve(name: str, dtype: str, layers: int = 2):
    """The port serves greedily; the reference decodes the same tokens;
    both are held to the reference's forward over all S+T tokens.  Also
    returns each run's MoE routing (:func:`record_moe_routes`)."""
    rm, rp, m, p = zoo_pair(name, dtype, layers=layers, seed=1,
                            no_drop=name in ZOO_MOE)
    cfg = m.cfg
    if cfg.moe is not None:
        for tg in (B * S, B * (S + T - 1), B):  # prefill, forward, decode
            tg = min(cfg.moe.group_size, tg)
            assert _capacity(cfg.moe, tg) >= tg, (tg, cfg.moe)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = {}
    if cfg.frontend == "vision_patches":
        extra["patch_embeds"] = (rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    off = cfg.frontend_tokens if extra else 0
    textra = {k: torch.from_numpy(v) for k, v in extra.items()}

    prefill, decode = make_prefill_step(m), make_decode_step(m)
    with record_moe_routes() as served:
        logits, caches = prefill(p, {"tokens": torch.from_numpy(prompt),
                                     **textra})
        caches = pad_caches(m, caches, B, off + S + T)
        index = torch.tensor(off + S, dtype=torch.int32)
        steps, tokens = [logits], [prompt]
        for _ in range(T - 1):
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            tokens.append(tok.numpy())
            logits, caches = decode(p, caches, {"tokens": tok,
                                                "index": index})
            index = index + 1
            steps.append(logits)
    seq = np.concatenate(tokens, axis=1)                     # (B, S + T - 1)

    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    with record_moe_routes() as forwards:
        want, _ = jax.jit(rm.forward)(rp, {"tokens": jnp.asarray(seq),
                                           **jextra})
        own, _ = m.forward(p, {"tokens": torch.from_numpy(seq), **textra})
    with record_moe_routes() as ref_served:
        rl, rc = jax.jit(rm.prefill)(rp, {"tokens": jnp.asarray(prompt),
                                          **jextra})
        rc = ref_pad_caches(rm, rc, B, off + S + T)
        ref_steps, rdec = [rl], jax.jit(rm.decode)
        for i in range(T - 1):
            rl, rc = rdec(rp, rc, {
                "tokens": jnp.asarray(seq[:, S + i:S + i + 1]),
                "index": jnp.asarray(off + S + i, jnp.int32)})
            ref_steps.append(rl)
    routes = {"port": served["port"], "ref": ref_served["ref"],
              "port_forward": forwards["port"], "ref_forward": forwards["ref"]}
    return steps, ref_steps, want, own, routes


def _step_routes(calls, n_moe: int):
    """A serving run's MoE routing at the tokens its steps' logits read:
    the prefill's last position, then each decode step's token; one
    entry a MoE layer, rows (B, T) flattened."""
    out = []
    for layer in range(n_moe):
        rows = [tuple(a.reshape(B, S, -1)[:, -1] for a in calls[layer])]
        for i in range(T - 1):
            rows.append(tuple(a.reshape(B, 1, -1)[:, 0]
                              for a in calls[n_moe * (i + 1) + layer]))
        out.append(tuple(np.stack([r[j] for r in rows], axis=1).reshape(
            B * T, -1) for j in range(3)))
    return out


def _forward_routes(calls, off: int):
    """A forward's MoE routing at positions S-1 .. S+T-2, as
    :func:`_step_routes` lays it out."""
    return [tuple(a.reshape(B, off + S + T - 1, -1)[:, off + S - 1:]
                  .reshape(B * T, -1) for a in call) for call in calls]


@pytest.mark.parametrize("name,dtype,layers", [
    pytest.param(name, dtype, 2, id=f"{name}-{dtype}")
    for name in ("qwen3-4b", "gemma2-9b", "internvl2-1b", *ZOO_MOE)
    for dtype in ("float32", "bfloat16")] + [
    pytest.param(name, "float32", 8, id=f"{name}-float32-8layers")
    for name in ZOO_MOE])
def test_greedy_decode_matches_the_teacher_forced_forward(name, dtype,
                                                          layers):
    """Two layers in f32 and bf16; the MoE configs also at eight layers in
    f32, seven of them MoE layers (in bf16 their decode drifts from the
    forward with depth in both packages, by near-tie routing flips; f32
    holds the same path closely, as the H100 run does at full depth)."""
    steps, ref_steps, want, own, routes = _serve(name, dtype, layers)
    n_moe = len(routes["port_forward"])
    off = want.shape[1] - (S + T - 1)
    flips = {
        "port": routing_flips(_forward_routes(routes["ref_forward"], off),
                              _step_routes(routes["port"], n_moe)),
        "own": routing_flips(_forward_routes(routes["port_forward"], off),
                             _step_routes(routes["port"], n_moe)),
        "ref": routing_flips(_forward_routes(routes["ref_forward"], off),
                             _step_routes(routes["ref"], n_moe)),
    }

    def close(got, w, which, i, msg):
        mask, notes = flips[which]
        skip = mask.reshape(B, T)[:, i] if mask.size else None
        assert_rows_close(got, w, tol, skip, [msg, *notes])

    for i, (got, ref) in enumerate(zip(steps, ref_steps)):
        w = as_np(want[:, S - 1 + i])
        tol = zoo_tol(dtype, w)
        # the port's step against the reference's forward ...
        close(got[:, 0], w, "port", i, f"port step {i}")
        # ... against its own forward, and the reference's step against
        # the reference's forward: the oracle holds in both packages
        close(got[:, 0], as_np(own[:, S - 1 + i]), "own", i,
              f"port step {i} vs port forward")
        close(ref[:, 0], w, "ref", i, f"reference step {i}")


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


@pytest.mark.parametrize("name", ["gemma2-9b", "internvl2-1b", *ZOO_MOE])
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
