"""The port's motifs against the JAX package's, on the same inputs.

Inputs are made by the port's ``make_inputs`` from a seed, held to the
reference's keys, shapes and dtypes, and carried over as numpy (uint32 and
bfloat16 kept), then both packages run the same variant: the reference on its
Pallas substrate (interpret mode), the port on ``"hopper"``, whose kernel
wrappers take the plain versions for CPU tensors.

Tolerances: ``rtol=1e-3, atol=1e-3`` for float outputs, the reference's
own substrate-parity bound (f32 sums and products in another order);
sorts, argmins, counts and min/max are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (as_np, assert_trees_close, jax_tree_to_numpy,
                          torch_tree_to_jax, tree_structure)

from repro.core.motifs import PVector as JPVector
from repro.core.motifs import get_motif as jget_motif
from repro_torch.convert import tensors_from_numpy
from repro_torch.core.motifs import SUBSTRATES, PVector, get_motif, lowered_motifs
from repro_torch.core.motifs.base import (_tree_perturb, register_lowering,
                                          get_lowering)

KEY = jax.random.key(11)
P_SMALL = dict(data_size=768, chunk_size=96, num_tasks=2, batch_size=2,
               height=8, width=8, channels=4)
FLOAT_TOL = dict(rtol=1e-3, atol=1e-3)
EXACT_KEYS = {"keys", "payload", "assign", "counts", "out_deg", "in_deg",
              "max_in", "min", "max", "task_min"}

LOWERED_CASES = [
    ("sort", "quick"), ("sort", "merge"),
    ("matrix", "euclidean"), ("matrix", "cosine"),
    ("matrix", "matmul"), ("matrix", "fully_connected"),
    ("statistics", "average"), ("statistics", "batchnorm"),
]
DECLINED_CASES = [("sort", "minmax"), ("matrix", "construct"),
                  ("statistics", "count"), ("statistics", "degree"),
                  ("statistics", "softmax")]


def _inputs(motif_name, p_kw):
    """(reference P, port P, the inputs as JAX arrays, the inputs).

    The port makes them from a seed (the reference's eager ``make_inputs``
    would compile every small op on its own); the reference's
    ``make_inputs``, evaluated abstractly, fixes their keys, shapes and
    dtypes."""
    jp, tp = JPVector(**p_kw), PVector(**p_kw)
    tin = get_motif(motif_name).make_inputs(tp, 11, "cpu")
    shapes = jax.eval_shape(
        lambda key: jget_motif(motif_name).make_inputs(jp, key), KEY)
    assert tree_structure(tin) == tree_structure(shapes)
    return jp, tp, torch_tree_to_jax(tin), tin


def _ref_run(motif_name, method, p, variant, jin):
    """The reference's motif method under one ``jax.jit`` (op-by-op eager
    dispatch would compile every small op on its own)."""
    fn = getattr(jget_motif(motif_name), method)
    return jax.jit(lambda inp: fn(p, inp, variant))(jin)


def _compare(want, got):
    for k in want:
        if k in EXACT_KEYS:
            assert_trees_close({k: want[k]}, {k: got[k]}, 0, 0)
        else:
            assert_trees_close({k: want[k]}, {k: got[k]}, **FLOAT_TOL)
    assert set(want) == set(got)


def test_registry_surface():
    assert SUBSTRATES == ("torch", "hopper")
    assert lowered_motifs() == ("matrix", "sort", "statistics")
    for m in lowered_motifs():
        assert callable(get_lowering(m, "hopper"))
    with pytest.raises(ValueError):
        register_lowering("sort", "torch")  # the stock form is no hook
    with pytest.raises(ValueError):
        register_lowering("sort", "pallas")
    motif = get_motif("sort")
    p = PVector(data_size=256)
    inputs = motif.make_inputs(p, 0, "cpu")
    with pytest.raises(ValueError, match="substrate"):
        motif.execute(p.replace(substrate="tpu"), inputs, "quick")


@pytest.mark.parametrize("motif_name,variant", LOWERED_CASES)
def test_lowered_variant_matches_reference(motif_name, variant):
    jp, tp, jin, tin = _inputs(motif_name, P_SMALL)
    want = _ref_run(motif_name, "execute", jp.replace(substrate="pallas"),
                    variant, jin)
    got = get_motif(motif_name).execute(tp.replace(substrate="hopper"), tin,
                                        variant)
    _compare(want, got)


@pytest.mark.parametrize("p_kw", [
    dict(data_size=1000, chunk_size=130, num_tasks=3),   # non-pow2 chunk
    dict(data_size=640, chunk_size=64, num_tasks=5),     # odd task count
])
@pytest.mark.parametrize("motif_name,variant",
                         [("sort", "merge"), ("statistics", "average")])
def test_lowered_parity_across_chunk_layouts(motif_name, variant, p_kw):
    jp, tp, jin, tin = _inputs(motif_name, p_kw)
    want = _ref_run(motif_name, "apply", jp, variant, jin)
    got = get_motif(motif_name).execute(tp.replace(substrate="hopper"), tin,
                                        variant)
    _compare(want, got)


@pytest.mark.parametrize("dtype", ["uint32", "int32", "float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["quick", "merge"])
def test_sort_parity_across_key_dtypes(variant, dtype):
    if dtype in ("uint32", "int32"):
        keys = jax.random.bits(KEY, (600,), jnp.uint32).astype(dtype)
    else:
        keys = jax.random.normal(KEY, (600,), jnp.float32).astype(dtype)
    jin = {"keys": keys,
           "payload": jax.random.bits(jax.random.fold_in(KEY, 1), (600, 2),
                                      jnp.uint32)}
    tin = tensors_from_numpy(jax_tree_to_numpy(jin), "cpu")
    assert tin["keys"].dtype == getattr(torch, dtype)
    p_kw = dict(data_size=600, chunk_size=72, num_tasks=3)
    want = _ref_run("sort", "apply", JPVector(**p_kw), variant, jin)
    got = get_motif("sort").execute(PVector(**p_kw, substrate="hopper"), tin,
                                    variant)
    assert got["keys"].dtype == getattr(torch, dtype)
    _compare(want, got)


@pytest.mark.parametrize("motif_name,variant", DECLINED_CASES)
def test_declined_variant_is_the_stock_form(motif_name, variant):
    """A declined variant runs ``apply`` — bit for bit — and matches the
    reference's stock form."""
    jp, tp, jin, tin = _inputs(motif_name, P_SMALL)
    motif = get_motif(motif_name)
    stock = motif.apply(tp, tin, variant)
    routed = motif.execute(tp.replace(substrate="hopper"), tin, variant)
    for k in stock:
        assert torch.equal(stock[k], routed[k]), k
    _compare(_ref_run(motif_name, "apply", jp, variant, jin), routed)


def test_weighted_apply_routes_through_substrate():
    kw = dict(P_SMALL, weight=2.0)
    jp, tp, jin, tin = _inputs("matrix", kw)
    want = _ref_run("matrix", "weighted_apply",
                    jp.replace(substrate="pallas"), "matmul", jin)
    got = get_motif("matrix").weighted_apply(
        tp.replace(substrate="hopper"), tin, "matmul")
    _compare(want, got)


def test_tree_perturb_leaves_int32_alone_and_xors_uint32():
    """The reference's quirk: int32 leaves are not perturbed; uint32 and
    other integer leaves are XORed with (eps != 0)."""
    tree = {"i32": torch.arange(4, dtype=torch.int32),
            "u32": torch.arange(4, dtype=torch.int32).view(torch.uint32),
            "f": torch.zeros(2)}
    out = _tree_perturb(tree, torch.tensor(1e-12))
    assert torch.equal(out["i32"], tree["i32"])
    assert as_np(out["u32"]).tolist() == [1, 0, 3, 2]
    assert as_np(out["f"]).tolist() == [np.float32(1e-12)] * 2


@pytest.mark.parametrize("p_kw", [
    {}, P_SMALL, dict(weight=3.4, sparsity=0.9, dist_scale=2.0),
    dict(distribution="zipf", zipf_alpha=1.5, dtype="bfloat16",
         layout="NCHW", total_size=4096),
])
@pytest.mark.parametrize("substrate", [("xla", "torch"),
                                       ("pallas", "hopper")])
@pytest.mark.parametrize("include_repeats", [True, False])
def test_structural_key_matches_reference(p_kw, substrate, include_repeats):
    want = JPVector(**p_kw, substrate=substrate[0]).structural_key(
        include_repeats)
    got = PVector(**p_kw, substrate=substrate[1]).structural_key(
        include_repeats)
    assert tuple(substrate[1] if v == substrate[0] else v
                 for v in want) == got
    assert JPVector(**p_kw).lifted_row() == PVector(**p_kw).lifted_row()


def test_weighted_apply_dynamic_takes_an_explicit_repeat_count():
    motif = get_motif("matrix")
    p = PVector(**P_SMALL)
    inputs = motif.make_inputs(p, 0, "cpu")
    want = motif.weighted_apply(p.replace(weight=3.0), inputs, "matmul")
    got = motif.weighted_apply_dynamic(p, inputs, "matmul",
                                       reps=torch.tensor(3.0))
    assert torch.equal(want["y"], got["y"])
    assert torch.equal(motif.weighted_apply_dynamic(p, inputs, "matmul")["y"],
                       motif.execute(p, inputs, "matmul")["y"])
