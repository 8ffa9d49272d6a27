"""The port's parameter and cache metadata (``repro_torch.models.params``
and the models' ``param_meta``/``cache_meta``) against the JAX package's,
its init against the reference's init kinds and scales, and the weights
handed across by ``convert.model_params_from_reference``."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from torch_parity import ZOO_BUILDABLE, flat, jax_tree_to_numpy, zoo_pair

import repro.configs as R
import repro.models as RM
from repro.models.params import is_meta as ref_is_meta
import repro_torch.configs as P
from repro_torch.convert import model_params_from_reference
from repro_torch.models import build_model, count_params, params


def _ref_flat(tree) -> dict:
    leaves = jax.tree_util.tree_leaves_with_path(tree, is_leaf=ref_is_meta)
    return {"/".join(k.key for k in path): m for path, m in leaves}


def _meta_fields(m) -> tuple:
    dtype = m.dtype if isinstance(m.dtype, torch.dtype) else np.dtype(m.dtype)
    return (m.shape, str(dtype).replace("torch.", ""), m.axes, m.init,
            m.fan_in, m.scaled_std())


def _configs(name):
    return (P.get_config(name), R.get_config(name)), (
        P.reduced(P.get_config(name)), R.reduced(R.get_config(name)))


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("name", ZOO_BUILDABLE)
def test_param_meta_matches_the_reference(name, size):
    cfg, rcfg = _configs(name)[size == "reduced"]
    got = flat(build_model(cfg).param_meta())
    want = _ref_flat(RM.build_model(rcfg).param_meta())
    assert sorted(got) == sorted(want)
    for k in want:
        assert _meta_fields(got[k]) == _meta_fields(want[k]), k
    assert count_params(build_model(cfg).param_meta()) == RM.count_params(
        RM.build_model(rcfg).param_meta())


@pytest.mark.parametrize("batch,seq", [(2, 64), (1, 8192)])
@pytest.mark.parametrize("name", ZOO_BUILDABLE)
def test_cache_meta_matches_the_reference(name, batch, seq):
    (cfg, rcfg), _ = _configs(name)
    got = flat(build_model(cfg).cache_meta(batch, seq))
    want = _ref_flat(RM.build_model(rcfg).cache_meta(batch, seq))
    assert sorted(got) == sorted(want)
    for k in want:
        assert _meta_fields(got[k]) == _meta_fields(want[k]), k


def test_qwen3_4b_at_full_width_is_4_02_billion_f32_params():
    model = build_model(P.get_config("qwen3-4b"))
    n = count_params(model.param_meta())
    assert n == RM.count_params(RM.build_model(
        R.get_config("qwen3-4b")).param_meta())
    assert 4.0e9 < n < 4.05e9
    abstract = model.abstract()  # meta-device tensors: nothing allocated
    leaves = params.tree_leaves(abstract)
    assert all(t.device.type == "meta" for t in leaves)
    assert all(t.dtype == torch.float32 for t in leaves)
    assert sum(t.numel() for t in leaves) == n
    trunk = abstract["trunk"]["seg0"]["p0"]["mixer"]
    assert tuple(trunk["wq"].shape) == (36, 2560, 32, 128)
    assert tuple(trunk["wk"].shape) == (36, 2560, 8, 128)


def _init_pair(seed=0):
    cfg = P.reduced(P.get_config("qwen3-4b")).replace(norm="layernorm")
    rcfg = R.reduced(R.get_config("qwen3-4b")).replace(norm="layernorm")
    model = build_model(cfg)
    got = flat(model.init(torch.Generator().manual_seed(seed), device="cpu"))
    want = flat(jax_tree_to_numpy(RM.build_model(rcfg).init(
        jax.random.key(seed))))
    return model, got, want


def test_init_gives_ones_and_zeros_where_the_reference_does():
    model, got, want = _init_pair()
    metas = flat(model.param_meta())
    assert sorted(got) == sorted(want)
    kinds = {m.init for m in metas.values()}
    assert {"ones", "zeros", "embed", "scaled"} <= kinds
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        for value in (0.0, 1.0):
            assert (np.all(w == value)) == (np.all(g == value)), (k, value)


def test_init_draws_each_normal_leaf_at_its_std():
    model, got, _ = _init_pair()
    metas = flat(model.param_meta())
    checked = 0
    for k, m in metas.items():
        if m.init in ("zeros", "ones") or got[k].numel() < 4096:
            continue
        std = float(got[k].double().std())
        assert abs(std / m.scaled_std() - 1) < 0.05, (k, std, m.scaled_std())
        assert abs(float(got[k].double().mean())) < 0.05 * m.scaled_std()
        checked += 1
    assert checked >= 8


def test_init_is_its_seed():
    _, a, _ = _init_pair(seed=3)
    _, b, _ = _init_pair(seed=3)
    _, c, _ = _init_pair(seed=4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed/tokens"], c["embed/tokens"])


def test_init_casts_to_the_param_dtype():
    cfg = P.reduced(P.get_config("gemma2-9b")).replace(param_dtype="bfloat16")
    model = build_model(cfg)
    got = flat(model.init(torch.Generator().manual_seed(0), device="cpu"))
    metas = flat(model.param_meta())
    assert {k: t.dtype for k, t in got.items()} == {
        k: m.dtype for k, m in metas.items()}
    # the weights take param_dtype; the norms' scales stay f32, as in the
    # reference
    assert got["trunk/seg0/p0/mixer/wq"].dtype == torch.bfloat16
    assert got["final_norm/scale"].dtype == torch.float32


def test_init_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(P.reduced(P.get_config("qwen3-4b")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_reference_weights_carry_across_bit_for_bit(param_dtype):
    rm, rp, m, p = zoo_pair("gemma2-9b", param_dtype=param_dtype)
    want = flat(jax_tree_to_numpy(rp))
    got = flat(p)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        assert str(g.dtype).replace("torch.", "") == w.dtype.name, k
        bits = np.uint16 if w.dtype.name == "bfloat16" else np.uint32
        gbits = g.view(torch.int16 if bits is np.uint16 else torch.int32)
        np.testing.assert_array_equal(gbits.numpy().view(bits), w.view(bits))


def test_a_cache_tree_carries_across():
    import jax.numpy as jnp

    rm, rp, m, p = zoo_pair("gemma2-9b", "bfloat16")
    tokens = np.arange(2 * 20, dtype=np.int32).reshape(2, 20) % 512
    _, caches = jax.jit(rm.prefill)(rp, {"tokens": jnp.asarray(tokens)})
    want = flat(jax_tree_to_numpy(caches))
    got = flat(model_params_from_reference(jax_tree_to_numpy(caches), "cpu"))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got[k].view(torch.int16).numpy().view(np.uint16), w.view(np.uint16))
