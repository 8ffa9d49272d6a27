"""The zoo's MoE layer (``repro_torch.models.layers``: ``moe_meta``,
``_capacity``, ``moe_dispatch_sort``, ``moe_combine_sort``, ``moe_apply``
in both branches, ``moe_apply_einsum``) against the JAX package's
``repro.models.layers`` on the same numpy inputs and weights; the MoE
param tree carried across by ``convert.model_params_from_reference``;
and the full-width DeepSeek configs as meta tensors.

The dispatch's indices, weights and counts are held exactly, drops
included (the same assignments dropped); its buffer and the combine at
``F32_TOL`` in f32 and ``bf16_tol`` in bf16.  ``moe_apply`` takes the
same input in both packages, so its f32 router sees the same values and
routes alike: output and aux loss at ``F32_TOL`` / ``bf16_tol``.  The
sort dispatch and the einsum dispatch agree only where nothing drops:
under drops they give priority in different orders (the sort by expert,
then token; the einsum by choice rank, then token), in both packages."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (F32_TOL, ZOO_MOE, as_np, bf16_tol, flat,
                          jax_tree_to_numpy, no_drop_capacity, np_rand,
                          to_jax, to_torch)

import repro.configs as R
import repro.models as RM
from repro.models import layers as RL
from repro.models.params import init_params as ref_init
import repro_torch.configs as P
from repro_torch.convert import model_params_from_reference
from repro_torch.models import build_model, count_params
from repro_torch.models import layers as L
from repro_torch.models.params import tree_leaves


def _tol(dtype, want):
    return F32_TOL if dtype == "float32" else bf16_tol(want)


def _close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)


def _moe(mo, **kw):
    """The same MoE config in both packages."""
    return (dataclasses.replace(mo, **kw),
            R.MoEConfig(**dataclasses.asdict(dataclasses.replace(mo, **kw))))


def _routing(T: int, E: int, k: int, seed: int):
    """Top-k routing of T tokens over E experts from random logits, the
    weights normalised as ``moe_apply`` does: (probs (T, k), ids (T, k))."""
    logits = np_rand(seed, (T, E), "float32") * 2.0
    ids = np.argsort(-logits, axis=-1, kind="stable")[:, :k].astype(np.int32)
    p = np.exp(np.take_along_axis(logits, ids, -1))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32), ids


# (T, E, k, capacity_factor): no drops; drops at 0.5; k = 1 and k = 6; T
# not a multiple of 8
DISPATCH_CASES = {
    "no_drop": (40, 8, 2, None),
    "drops": (40, 8, 2, 0.5),
    "k1_ragged": (37, 4, 1, 0.5),
    "k6": (64, 16, 6, 1.25),
    "k6_ragged_drops": (29, 8, 6, 0.5),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_dispatch_and_combine_match_the_reference(case, dtype):
    T, E, k, cf = DISPATCH_CASES[case]
    base = P.MoEConfig(num_experts=E, experts_per_token=k, d_ff=16)
    mo, rmo = _moe(base, capacity_factor=cf or no_drop_capacity(base))
    C = L._capacity(mo, T)
    assert C == RL._capacity(rmo, T)
    d = 24
    x = np_rand(1, (T, d), "float32")
    probs, ids = _routing(T, E, k, seed=2)
    want = RL.moe_dispatch_sort(to_jax(x, dtype), to_jax(probs, dtype),
                                jnp.asarray(ids), rmo, C)
    got = L.moe_dispatch_sort(to_torch(x, dtype), to_torch(probs, dtype),
                              torch.from_numpy(ids.astype(np.int64)), mo, C)
    for name, w, g in zip(("slot", "st", "w", "counts"), want[1:], got[1:]):
        np.testing.assert_array_equal(as_np(g), as_np(w), err_msg=name)
    np.testing.assert_array_equal(as_np(got[0]), as_np(want[0]))
    dropped = int((as_np(want[3]) == 0).sum())
    if cf is None:
        assert C >= T and dropped == 0
    elif case != "k6":
        assert dropped > 0, "the case must drop assignments"

    y = np_rand(3, (E, C, d), "float32")
    w_c = RL.moe_combine_sort(to_jax(y, dtype), *want[1:4], T)
    g_c = L.moe_combine_sort(to_torch(y, dtype), *got[1:4], T)
    assert g_c.dtype == getattr(torch, dtype)
    _close(g_c, w_c, _tol(dtype, w_c))


def _layer(name: str, dtype: str, *, seed: int = 0, **moe_kw):
    """Reduced ``name``'s MoE layer params and config in both packages."""
    cfg = P.reduced(P.get_config(name)).replace(dtype=dtype)
    rcfg = R.reduced(R.get_config(name)).replace(dtype=dtype)
    if moe_kw:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
        rcfg = rcfg.replace(moe=dataclasses.replace(rcfg.moe, **moe_kw))
    rp = ref_init(jax.random.key(seed), RL.moe_meta(rcfg))
    return cfg, rcfg, rp, model_params_from_reference(jax_tree_to_numpy(rp),
                                                      "cpu")


def _x(shape, dtype, seed=5):
    a = np_rand(seed, shape, "float32")
    return to_jax(a, dtype), to_torch(a, dtype)


_REF_APPLY = jax.jit(RL.moe_apply, static_argnums=1)
_REF_EINSUM = jax.jit(RL.moe_apply_einsum, static_argnums=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("name", ZOO_MOE)
def test_moe_apply_matches_the_reference(name, groups, dtype):
    """The vmapped branch at the shipped capacity (it drops), one group of
    48 tokens or two of 64."""
    cfg, rcfg, rp, p = _layer(name, dtype)
    shape = (2, 24, cfg.d_model) if groups == 1 else (2, 64, cfg.d_model)
    jx, tx = _x(shape, dtype)
    want, want_aux = _REF_APPLY(rp, rcfg, jx)
    got, aux = L.moe_apply(p, cfg, tx)
    assert got.dtype == tx.dtype and aux.dtype == torch.float32
    _close(got, want, _tol(dtype, want))
    _close(aux, want_aux, _tol(dtype, want_aux))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_groups_matches_the_reference_and_the_batched_branch(dtype):
    """``scan_groups`` over G = 2 groups: a Python loop over groups, held
    to the reference's ``lax.map`` and to the port's own batched branch."""
    cfg, rcfg, rp, p = _layer("deepseek-v2-lite-16b", dtype, scan_groups=True)
    jx, tx = _x((2, 64, cfg.d_model), dtype)
    want, want_aux = _REF_APPLY(rp, rcfg, jx)
    got, aux = L.moe_apply(p, cfg, tx)
    _close(got, want, _tol(dtype, want))
    _close(aux, want_aux, _tol(dtype, want_aux))
    batched, b_aux = L.moe_apply(
        p, cfg.replace(moe=dataclasses.replace(cfg.moe, scan_groups=False)),
        tx)
    _close(got, batched, F32_TOL if dtype == "float32" else
           dict(rtol=2.0 ** -7, atol=1e-6))
    assert float(aux) == float(b_aux)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ZOO_MOE)
def test_einsum_dispatch_matches_the_reference_drops_included(name, dtype):
    cfg, rcfg, rp, p = _layer(name, dtype)
    jx, tx = _x((2, 24, cfg.d_model), dtype, seed=6)
    want, want_aux = _REF_EINSUM(rp, rcfg, jx)
    got, aux = L.moe_apply_einsum(p, cfg, tx)
    _close(got, want, _tol(dtype, want))
    _close(aux, want_aux, _tol(dtype, want_aux))


@pytest.mark.parametrize("name", ZOO_MOE)
def test_sort_dispatch_matches_the_einsum_dispatch_without_drops(name):
    """Where nothing drops the two dispatches compute the same function;
    under drops they differ by design (their priority orders differ)."""
    base = P.reduced(P.get_config(name)).moe
    cfg, _, _, p = _layer(name, "float32",
                          capacity_factor=no_drop_capacity(base))
    _, tx = _x((2, 24, cfg.d_model), "float32", seed=7)
    assert L._capacity(cfg.moe, 48) >= 48
    got, aux = L.moe_apply(p, cfg, tx)
    want, want_aux = L.moe_apply_einsum(p, cfg, tx)
    _close(got, want, F32_TOL)
    _close(aux, want_aux, F32_TOL)
    shipped = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=0.5))
    a, _ = L.moe_apply(p, shipped, tx)
    b, _ = L.moe_apply_einsum(p, shipped, tx)
    assert not np.allclose(as_np(a), as_np(b), **F32_TOL)


def test_moe_apply_refuses_a_partial_group():
    cfg, _, _, p = _layer("deepseek-v2-lite-16b", "float32")
    assert cfg.moe.group_size == 64
    with pytest.raises(ValueError, match="not divisible by group 64"):
        L.moe_apply(p, cfg, torch.zeros(2, 48 + 1, cfg.d_model))


@pytest.mark.parametrize("name", ZOO_MOE)
def test_convert_carries_the_moe_and_mla_trees(name):
    """The generic walk of ``model_params_from_reference`` carries the f32
    router, the stacked (E, d, ff) experts, the shared MLP and the MLA
    weights bit for bit, dtypes kept."""
    rcfg = R.reduced(R.get_config(name)).replace(param_dtype="bfloat16")
    rp = RM.build_model(rcfg).init(jax.random.key(3))
    want = flat(jax_tree_to_numpy(rp))
    got = flat(model_params_from_reference(jax_tree_to_numpy(rp), "cpu"))
    assert sorted(got) == sorted(want)
    moe = [k for k in want if "/ffn/" in k and k.startswith("trunk/seg1")]
    assert {k.rsplit("/", 1)[-1] for k in moe} >= {"router", "wi", "wg", "wo"}
    assert any("/shared/" in k for k in moe)
    assert any(k.endswith("mixer/wdkv") for k in want)
    for k, w in want.items():
        g = got[k]
        assert str(g.dtype).replace("torch.", "") == w.dtype.name, k
        if k.endswith("router"):
            assert g.dtype == torch.float32
        if k in moe and k.endswith("ffn/wi"):
            E, d, ff = rcfg.moe.num_experts, rcfg.d_model, rcfg.moe.d_ff
            assert tuple(g.shape)[-3:] == (E, d, ff)
        np.testing.assert_array_equal(as_np(g), w.astype(np.float32),
                                      err_msg=k)


@pytest.mark.parametrize("name", ZOO_MOE)
def test_full_width_deepseek_is_meta_only(name):
    """Full width and depth as meta tensors: the reference's parameter
    count (``param_counts()["total"]`` plus the norm scales it leaves
    out; deepseek-v3-671b: 671,025,397,760 + 1,006,592) and no storage."""
    cfg = P.get_config(name)
    model = build_model(cfg)
    meta = model.param_meta()
    n = count_params(meta)
    assert n == RM.count_params(RM.build_model(R.get_config(name))
                                .param_meta())
    norms = sum(int(np.prod(m.shape)) for k, m in flat(meta).items()
                if k.rsplit("/", 1)[-1] == "scale" or k.endswith("_norm"))
    assert n == cfg.param_counts()["total"] + norms
    if name == "deepseek-v3-671b":
        assert cfg.param_counts()["total"] == 671_025_397_760
        assert n == 671_025_397_760 + 1_006_592
    leaves = tree_leaves(model.abstract())
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == n
