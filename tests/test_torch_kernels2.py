"""The port's entry-point kernels — fused RMSNorm, flash attention and MoE
dispatch — against the JAX package.

The same numpy inputs go through ``repro.kernels`` (the Pallas kernels in
interpret mode, as ``tests/test_kernels.py`` runs them on the CPU, or the
jnp oracles of ``repro.kernels.ref``) and through
``repro_torch.kernels.ops``, whose wrappers run the plain versions for CPU
tensors.  The CUDA kernels themselves are compared with the plain
versions by ``test_torch_cuda.py``.

Tolerances, the reference's own (``tests/test_kernels.py``): rmsnorm f32
``rtol=1e-3, atol=1e-4``, bf16 ``rtol=atol=5e-2``; flash attention f32
``rtol=2e-3, atol=2e-4``, bf16 ``rtol=atol=5e-2``; MoE dispatch
``rtol=atol=1e-5``.  The dispatch mask is compared exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_np, np_rand, to_jax, to_torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.signature import profile_call
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

TOL = {"float32": dict(rtol=1e-3, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
FLASH_TOL = {"float32": dict(rtol=2e-3, atol=2e-4),
             "bfloat16": dict(rtol=5e-2, atol=5e-2)}
FLASH_SHAPES = [(1, 128, 1, 64), (2, 130, 4, 64), (1, 257, 2, 128)]


def _ids(seed: int, t: int, e: int) -> np.ndarray:
    return (np_rand(seed, (t,), "uint32") % e).astype(np.int32)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,d", [(8, 128), (33, 512), (256, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_pallas(rows, d, dtype):
    x, w = np_rand(20, (rows, d), "float32"), np_rand(21, (d,), "float32")
    want = jops.rmsnorm(to_jax(x, dtype), to_jax(w), interpret=True)
    got = tops.rmsnorm(to_torch(x, dtype), to_torch(w))
    assert got.dtype == getattr(torch, dtype) and got.shape == (rows, d)
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL[dtype])


def test_rmsnorm_keeps_leading_dims_and_eps():
    x, w = np_rand(22, (2, 3, 64), "float32"), np_rand(23, (64,), "float32")
    want = jref.rmsnorm(to_jax(x), to_jax(w), eps=1e-2)
    got = tops.rmsnorm(to_torch(x), to_torch(w), eps=1e-2)
    assert got.shape == (2, 3, 64)
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL["float32"])


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def _qkv(shape_q, shape_kv, dtype="float32"):
    arrays = (np_rand(30, shape_q, "float32"), np_rand(31, shape_kv, "float32"),
              np_rand(32, shape_kv, "float32"))
    return ([to_jax(a, dtype) for a in arrays],
            [to_torch(a, dtype) for a in arrays])


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference(shape, causal):
    (jq, jk, jv), (tq, tk, tv) = _qkv(shape, shape)
    want = jref.flash_attention(jq, jk, jv, causal=causal)
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(as_np(got), as_np(want), **FLASH_TOL["float32"])


def test_flash_attention_matches_pallas():
    shape = (2, 130, 4, 64)  # ragged Skv: two 64-key tiles and a partial one
    (jq, jk, jv), (tq, tk, tv) = _qkv(shape, shape)
    want = jops.flash_attention(jq, jk, jv, causal=True, bq=64, bk=64,
                                interpret=True)
    got = tops.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(as_np(got), as_np(want), **FLASH_TOL["float32"])


@pytest.mark.parametrize("sq,skv", [(64, 130), (130, 64)])
def test_flash_attention_causal_is_top_left_when_sq_differs(sq, skv):
    (jq, jk, jv), (tq, tk, tv) = _qkv((2, sq, 4, 64), (2, skv, 4, 64))
    want = jref.flash_attention(jq, jk, jv, causal=True)
    got = tops.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(as_np(got), as_np(want), **FLASH_TOL["float32"])
    # query 0 sees key 0 alone: its output is v's first row
    np.testing.assert_allclose(as_np(got)[:, 0], as_np(tv)[:, 0], rtol=1e-6,
                               atol=1e-6)


def test_flash_attention_bf16_matches_reference():
    (jq, jk, jv), (tq, tk, tv) = _qkv((2, 130, 4, 64), (2, 130, 4, 64),
                                      "bfloat16")
    want = jref.flash_attention(jq, jk, jv, causal=True)
    got = tops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(as_np(got), as_np(want),
                               **FLASH_TOL["bfloat16"])


def test_flash_attention_single_head_2d_layout():
    (jq, jk, jv), (tq, tk, tv) = _qkv((100, 32), (100, 32))
    want = jref.flash_attention(jq, jk, jv, causal=True)
    got = tfa.flash_attention_single(tq, tk, tv, causal=True)
    assert got.shape == (100, 32)
    np.testing.assert_allclose(as_np(got), as_np(want), **FLASH_TOL["float32"])
    np.testing.assert_array_equal(as_np(tops.flash_attention(tq, tk, tv)),
                                  as_np(got))


def test_flash_attention_carries_the_reference_constants():
    assert tfa.NEG_INF == jfa.NEG_INF == -1e30
    assert tfa.L_FLOOR == 1e-30  # the floor of l in _flash_kernel's store


@pytest.mark.parametrize("sq,skv", [(1, 1), (5, 5), (64, 130), (130, 64),
                                    (7, 3)])
@pytest.mark.parametrize("causal", [True, False])
def test_kept_pairs_counts_the_mask(sq, skv, causal):
    keep = np.ones((sq, skv), bool)
    if causal:
        keep = np.arange(skv)[None, :] <= np.arange(sq)[:, None]
    assert tfa.kept_pairs(sq, skv, causal) == int(keep.sum())


# ---------------------------------------------------------------------------
# MoE dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,e,c", [(64, 8, 16), (128, 4, 64), (300, 5, 7)])
def test_dispatch_mask_equals_reference(t, e, c):
    ids = _ids(40, t, e)
    want = jops.make_dispatch_mask(jnp.asarray(ids), e, c)
    got = tops.make_dispatch_mask(torch.from_numpy(ids), e, c)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(as_np(got), np.asarray(want))


def test_dispatch_mask_capacity_and_out_of_range_ids():
    # 10 tokens all to expert 0 at capacity 4: slots 0..3 kept, the rest
    # dropped (test_kernels.py's capacity case)
    ids = np.zeros((10,), np.int32)
    got = tops.make_dispatch_mask(torch.from_numpy(ids), 2, 4)
    np.testing.assert_array_equal(
        as_np(got), np.asarray(jops.make_dispatch_mask(jnp.asarray(ids), 2, 4)))
    assert float(got.sum()) == 4.0
    assert bool((got[:4, 0].sum(-1) == 1.0).all())
    assert bool((got[4:] == 0.0).all())
    # ids outside [0, E) give zero rows, as jax.nn.one_hot does
    odd = np.array([0, -1, 3, 1, 7, 1], np.int32)
    np.testing.assert_array_equal(
        as_np(tops.make_dispatch_mask(torch.from_numpy(odd), 3, 2)),
        np.asarray(jops.make_dispatch_mask(jnp.asarray(odd), 3, 2)))


@pytest.mark.parametrize("t,e,c,d", [(64, 8, 16, 32), (128, 4, 64, 16)])
@pytest.mark.parametrize("mask_kind", ["routed", "dense"])
def test_moe_dispatch_matches_pallas(t, e, c, d, mask_kind):
    if mask_kind == "routed":
        mask = np.asarray(jops.make_dispatch_mask(jnp.asarray(_ids(41, t, e)),
                                                  e, c))
    else:
        mask = np_rand(42, (t, e, c), "float32")
    x = np_rand(43, (t, d), "float32")
    want = jops.moe_dispatch(to_jax(mask), to_jax(x), interpret=True)
    got = tops.moe_dispatch(to_torch(mask), to_torch(x))
    assert got.shape == (e, c, d)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-5, atol=1e-5)


def test_moe_dispatch_casts_the_mask_to_x_dtype():
    # the reference casts the mask to x.dtype before the product; a mask
    # value that bf16 rounds shows it
    mask = np.full((4, 2, 3), 1.0 + 2.0 ** -10, np.float32)
    x = np.ones((4, 5), np.float32)
    want = jops.moe_dispatch(to_jax(mask), to_jax(x, "bfloat16"),
                             interpret=True)
    got = tops.moe_dispatch(to_torch(mask), to_torch(x, "bfloat16"))
    np.testing.assert_array_equal(as_np(got), as_np(want))
    assert float(got[0, 0, 0]) == 4.0


# ---------------------------------------------------------------------------
# wrappers and profile
# ---------------------------------------------------------------------------


def test_new_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.randn(4, 8)
    with pytest.raises(ValueError, match=r"w of shape"):
        tops.rmsnorm(x, torch.randn(7))
    with pytest.raises(TypeError):
        tops.rmsnorm(x.double(), torch.randn(8).double())
    with pytest.raises(ValueError, match="contiguous"):
        tops.rmsnorm(torch.randn(8, 4).T, torch.randn(8))
    q = torch.randn(1, 6, 2, 8)
    with pytest.raises(ValueError):
        tops.flash_attention(q[0], q[0], q[0])  # rank 3
    with pytest.raises(ValueError, match="head width"):
        tops.flash_attention(q, torch.randn(1, 6, 2, 16), torch.randn(1, 6, 2, 16))
    with pytest.raises(ValueError, match="head widths"):
        big = torch.randn(1, 2, 1, 300)
        tops.flash_attention(big, big, big)
    with pytest.raises(TypeError):
        tops.flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError):
        tfa.flash_attention_single(q, q, q)
    with pytest.raises(ValueError):
        tops.moe_dispatch(torch.ones(6, 2), torch.randn(6, 4))  # rank 2
    with pytest.raises(ValueError):
        tops.moe_dispatch(torch.ones(6, 2, 3), torch.randn(5, 4))  # T
    with pytest.raises(TypeError):
        tops.moe_dispatch(torch.ones(6, 2, 3, dtype=torch.int32),
                          torch.randn(6, 4))


def test_profile_classes_and_flops_of_the_new_kernels():
    q = torch.randn(2, 10, 3, 16)
    kv = torch.randn(2, 7, 3, 16)
    mask, x, w = torch.ones(6, 2, 3), torch.randn(6, 4), torch.ones(4)
    sig = profile_call(lambda: tops.flash_attention(q, kv, kv, causal=True))
    assert sig.dot_flops == 4.0 * 2 * 3 * 16 * tfa.kept_pairs(10, 7, True)
    assert sig.raw_cost == {"ops_dot": 1.0}
    sig = profile_call(lambda: tops.moe_dispatch(mask, x))
    assert sig.dot_flops == 2.0 * 6 * 2 * 3 * 4
    sig = profile_call(lambda: tops.rmsnorm(x, w))
    assert sig.raw_cost == {"ops_reduce": 1.0} and sig.dot_flops == 0.0
