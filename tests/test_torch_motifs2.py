"""The five motifs of the second slice — sampling, graph, transform, logic
and set — against the JAX package's, on the same inputs.

Inputs are made by the port's ``make_inputs`` from a seed, held to the
reference's keys, shapes and dtypes (the reference's PRNG key leaf ``rng``
is the port's 0-d int32 seed), and carried over as numpy; both packages
then run the same variant, the reference under one ``jax.jit`` on its
Pallas substrate and the port on ``"hopper"``.  No new variant has a
kernel: both substrates decline every one of them.

Tolerances: integers, keys, masks, offsets, counts, ``col``, ``visited``
and sorted outputs exact; float outputs ``rtol=atol=1e-3`` (``FLOAT_TOL``,
the reference's own substrate-parity bound: f32 sums and products in
another order).  random, dropout and topk draw from another generator
than the reference's, so they are held to their distributions and
invariants only.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from torch_parity import as_np, to_jax

from repro.core.decompose import decompose as jdecompose
from repro.core.motifs import PVector as JPVector
from repro.core.motifs import get_motif as jget_motif
from repro.core.motifs import motif_names as jmotif_names
from repro.core.signature import Signature as JSignature
from repro.core.signature import (_INSTR_RE, _split_computations,
                                  classify_opcode)
from repro_torch.core.decompose import OPCLASS_TO_MOTIF, decompose
from repro_torch.core.motifs import PVector, get_motif, motif_names
from repro_torch.core.signature import Signature, classify_op

KEY = jax.random.key(11)
P_SMALL = dict(data_size=768, chunk_size=96, num_tasks=2, batch_size=2,
               height=8, width=8, channels=4)
FLOAT_TOL = dict(rtol=1e-3, atol=1e-3)
NEW_MOTIFS = ("sampling", "graph", "transform", "logic", "set")
RANDOM_VARIANTS = {("sampling", "random"), ("sampling", "dropout"),
                   ("sampling", "topk")}
ALL_NEW_CASES = [(m, v) for m in NEW_MOTIFS
                 for v in jget_motif(m).variants]
DETERMINISTIC_CASES = [c for c in ALL_NEW_CASES if c not in RANDOM_VARIANTS]
#: P variations a variant's parity also holds at: NCHW images, zipf keys
#: and graphs (duplicated keys: set hits, hub vertices), a non-pow2 chunk
P_VARIANTS = {
    "nhwc": {},
    "nchw": dict(layout="NCHW"),
    "zipf": dict(distribution="zipf", data_size=1000, chunk_size=130,
                 num_tasks=3),
}


def _structure(tree) -> dict:
    """key -> (shape, dtype); the reference's PRNG key leaf and the
    port's 0-d int32 seed both read as ``("rng", ())``."""
    out = {}
    for k, v in tree.items():
        dt = str(v.dtype).replace("torch.", "")
        if k == "rng":
            assert dt in ("int32",) or jax.dtypes.issubdtype(
                v.dtype, jax.dtypes.prng_key), (k, dt)
            dt = "rng"
        out[k] = (tuple(v.shape), dt)
    return out


def _inputs(motif_name, p_kw):
    """(reference P, port P, the inputs as JAX arrays, the inputs); the
    reference's ``make_inputs``, evaluated abstractly, fixes their keys,
    shapes and dtypes."""
    jp, tp = JPVector(**p_kw), PVector(**p_kw)
    tin = get_motif(motif_name).make_inputs(tp, 11, "cpu")
    shapes = jax.eval_shape(
        lambda key: jget_motif(motif_name).make_inputs(jp, key), KEY)
    assert _structure(tin) == _structure(shapes)
    jin = {k: KEY if k == "rng" else to_jax(as_np(v),
                                            str(v.dtype).replace("torch.", ""))
           for k, v in tin.items()}
    return jp, tp, jin, tin


def _ref_run(motif_name, method, p, variant, jin):
    fn = getattr(jget_motif(motif_name), method)
    return jax.jit(lambda inp: fn(p, inp, variant))(jin)


def _compare(want, got):
    assert set(want) == set(got)
    for k in want:
        w, g = np.asarray(want[k]), as_np(got[k])
        assert w.shape == g.shape, (k, w.shape, g.shape)
        assert w.dtype == g.dtype, (k, w.dtype, g.dtype)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(w, g, err_msg=k, **FLOAT_TOL)
        else:
            np.testing.assert_array_equal(w, g, err_msg=k)


@pytest.mark.parametrize("name", jmotif_names())
def test_every_motif_mirrors_the_reference(name):
    assert motif_names() == jmotif_names()
    ref, port = jget_motif(name), get_motif(name)
    for field in ("name", "variants", "default_variant", "tunable",
                  "data_kind"):
        assert getattr(port, field) == getattr(ref, field), field


@pytest.mark.parametrize("pv", sorted(P_VARIANTS))
@pytest.mark.parametrize("motif_name,variant", DETERMINISTIC_CASES)
def test_variant_matches_reference(motif_name, variant, pv):
    kw = dict(P_SMALL, **P_VARIANTS[pv])
    jp, tp, jin, tin = _inputs(motif_name, kw)
    want = _ref_run(motif_name, "execute", jp.replace(substrate="pallas"),
                    variant, jin)
    got = get_motif(motif_name).execute(tp.replace(substrate="hopper"), tin,
                                        variant)
    _compare(want, got)


@pytest.mark.parametrize("motif_name,variant", [
    ("logic", "bitops"), ("logic", "crc"), ("graph", "traversal"),
    ("transform", "conv2d"), ("set", "union"), ("sampling", "maxpool"),
])
def test_weighted_apply_matches_reference(motif_name, variant):
    """Weight 3: outputs fed back through ``_tree_perturb`` (uint32 XORed,
    int32 and the rng seed left alone, floats shifted)."""
    jp, tp, jin, tin = _inputs(motif_name, dict(P_SMALL, weight=3.0))
    want = _ref_run(motif_name, "weighted_apply", jp, variant, jin)
    got = get_motif(motif_name).weighted_apply(tp, tin, variant)
    _compare(want, got)


@pytest.mark.parametrize("motif_name,variant", ALL_NEW_CASES)
def test_declined_variant_is_the_stock_form(motif_name, variant):
    """Every new variant runs ``apply`` on ``"hopper"``, bit for bit."""
    _, tp, _, tin = _inputs(motif_name, P_SMALL)
    motif = get_motif(motif_name)
    stock = motif.apply(tp, tin, variant)
    routed = motif.execute(tp.replace(substrate="hopper"), tin, variant)
    assert set(stock) == set(routed)
    for k in stock:
        np.testing.assert_array_equal(as_np(stock[k]), as_np(routed[k]),
                                      err_msg=k)


def _random_run(variant, **kw):
    p_kw = dict(P_SMALL, data_size=1 << 14, batch_size=8, height=16,
                width=16, **kw)
    jp, tp, jin, tin = _inputs("sampling", p_kw)
    want = jax.eval_shape(
        lambda i: jget_motif("sampling").apply(jp, i, variant), jin)
    got = get_motif("sampling").execute(tp.replace(substrate="hopper"), tin,
                                        variant)
    assert {k: (v.shape, str(v.dtype)) for k, v in want.items()} == {
        k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
        for k, v in got.items()}
    again = get_motif("sampling").apply(tp, tin, variant)
    for k in got:  # the same seed leaf draws the same values
        assert torch.equal(got[k], again[k]), k
    return tin, got


def test_random_splits_are_sorted_draws_of_the_keys():
    tin, got = _random_run("random")
    splits = as_np(got["splits"]).astype(np.int64)
    assert np.all(np.diff(splits) >= 0)
    assert np.isin(splits, as_np(tin["keys"]).astype(np.int64)).all()
    # a uniform sample's split points spread over the key range
    assert splits[0] < (1 << 31) < splits[-1]


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_dropout_keeps_half_and_doubles_them(layout):
    tin, got = _random_run("dropout", layout=layout)
    x = tin["images"]
    if layout == "NCHW":
        x = x.permute(0, 2, 3, 1)
    y = got["y"]
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.02
    torch.testing.assert_close(y[kept], 2.0 * x[kept], rtol=0, atol=0)


def test_topk_values_descend_and_index_the_scores():
    _, got = _random_run("topk")
    vals, idx = got["vals"], got["idx"]
    assert bool((vals[:, 0] >= vals[:, 1]).all())
    assert bool((idx[:, 0] != idx[:, 1]).all())
    assert int(idx.min()) >= 0 and int(idx.max()) < P_SMALL["channels"]
    # 4097 rows of four uniform scores in [-1, 1): the largest of four
    # averages 0.6, the second 0.2 (standard errors ~0.006)
    assert abs(float(vals[:, 0].mean()) - 0.6) < 0.03
    assert abs(float(vals[:, 1].mean()) - 0.2) < 0.03


# -- profiles of the new motifs' ops ------------------------------------------


class _Seen(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.classes = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.classes[func.overloadpacket.__name__] = classify_op(func)
        return func(*args, **(kwargs or {}))


def _ref_opcodes(fn, *args) -> dict:
    """opcode -> class over every computation of the reference's compiled
    program (fused bodies included)."""
    text = jax.jit(fn).lower(*args).compile().as_text()
    seen = {}
    for lines in _split_computations(text).values():
        for line in lines:
            m = _INSTR_RE.match(line)
            if m:
                seen[m.group(3)] = classify_opcode(m.group(3))
    return seen


def _jconv(x, w):
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape,
                                        ("NCHW", "OIHW", "NCHW"))
    return jax.lax.conv_general_dilated(x, w, (1, 1), "SAME",
                                        dimension_numbers=dn)


def _jpool(op, init):
    return lambda x: jax.lax.reduce_window(x, init, op, (1, 1, 2, 2),
                                           (1, 1, 2, 2), "VALID")


def _grad(fn, *xs):
    xs = [x.requires_grad_() for x in xs]
    return torch.autograd.grad(fn(*xs).sum(), xs)


_X = np.random.default_rng(0).standard_normal((2, 4, 8, 8)).astype(np.float32)
_W = np.random.default_rng(1).standard_normal((4, 4, 3, 3)).astype(np.float32)
_SIG = np.random.default_rng(2).standard_normal((4, 256)).astype(np.float32)

#: (port op, reference opcode, port fn, reference fn, inputs); the
#: reference's CPU compiler lowers select-and-scatter (the max pool's
#: backward) to reduce-window and scatter, and keeps reduce-window
ONE_OP_CASES = {
    "conv_backward": ("convolution_backward", "convolution",
                      lambda x, w: _grad(
                          lambda a, b: F.conv2d(a, b, padding=1), x, w),
                      jax.grad(lambda x, w: _jconv(x, w).sum(), (0, 1)),
                      (_X, _W)),
    "maxpool": ("max_pool2d_with_indices", "reduce-window",
                lambda x: F.max_pool2d(x, 2, 2),
                _jpool(jax.lax.max, -jnp.inf), (_X,)),
    "maxpool_backward": ("max_pool2d_with_indices_backward", "reduce-window",
                         lambda x: _grad(lambda a: F.max_pool2d(a, 2, 2), x),
                         jax.grad(lambda x: _jpool(jax.lax.max, -jnp.inf)(
                             x).sum()), (_X,)),
    "avgpool": ("avg_pool2d", "reduce-window",
                lambda x: F.avg_pool2d(x, 2, 2),
                lambda x: _jpool(jax.lax.add, 0.0)(x) / 4.0, (_X,)),
    "avgpool_backward": ("avg_pool2d_backward", "reduce-window",
                         lambda x: _grad(lambda a: F.avg_pool2d(a, 2, 2), x),
                         jax.grad(lambda x: _jpool(jax.lax.add, 0.0)(
                             x).sum() / 4.0), (_X,)),
    "relu_backward": ("threshold_backward", "select",
                      lambda x: _grad(torch.relu, x),
                      jax.grad(lambda x: jax.nn.relu(x).sum()), (_X,)),
    "segment_max": ("scatter_reduce_", "scatter",
                    lambda x: torch.zeros(4).scatter_reduce_(
                        0, torch.tensor([0, 1, 1, 3] * 8), x.reshape(-1)[:32],
                        "amax", include_self=True),
                    lambda x: jax.ops.segment_max(
                        x.reshape(-1)[:32], jnp.array([0, 1, 1, 3] * 8),
                        num_segments=4), (_X,)),
    "rfft": ("_fft_r2c", "fft", lambda s: torch.fft.rfft(s, dim=-1),
             lambda s: jnp.fft.rfft(s, axis=-1), (_SIG,)),
}


@pytest.mark.parametrize("case", sorted(ONE_OP_CASES))
def test_one_op_programs_land_in_the_reference_class(case):
    op, opcode, tfn, jfn, xs = ONE_OP_CASES[case]
    with _Seen() as seen:
        tfn(*[torch.from_numpy(x.copy()) for x in xs])
    ref = _ref_opcodes(jfn, *[jnp.asarray(x) for x in xs])
    assert opcode in ref, sorted(ref)
    assert seen.classes[op] == ref[opcode]
    if case == "conv_backward":
        assert ref[opcode] == "conv"


def test_convolution_backward_counts_both_products():
    """A backward convolution is two products (input and weight grads):
    twice the forward's flops, all in ``conv_flops``."""
    from repro_torch.core.signature import profile_call

    x, w = torch.from_numpy(_X.copy()), torch.from_numpy(_W.copy())
    fwd = profile_call(lambda a, b: F.conv2d(a, b, padding=1), x, w)
    both = profile_call(lambda a, b: _grad(
        lambda c, d: F.conv2d(c, d, padding=1), a, b), x, w)
    assert fwd.conv_flops == fwd.flops > 0
    assert both.conv_flops == 3 * fwd.conv_flops


# -- decomposition without hints ------------------------------------------------


def test_decompose_without_hints_accepts_every_op_class():
    classes = sorted(OPCLASS_TO_MOTIF)
    sig = Signature(flops=1e9, bytes=1e8, dot_flops=2e8, conv_flops=3e8,
                    op_mix={c: 1e6 * (i + 1) for i, c in enumerate(classes)})
    pb = decompose(sig, name="all")
    pb.validate()
    want = jdecompose(JSignature(**dataclasses.asdict(sig)), name="all")
    assert [(n.id, n.motif, n.variant, n.deps) for n in pb.nodes] == [
        (n.id, n.motif, n.variant, n.deps) for n in want.nodes]
    assert {(n.motif, n.variant) for n in pb.nodes} == set(
        OPCLASS_TO_MOTIF.values())
    assert set(motif_names()) >= {m for m, _ in OPCLASS_TO_MOTIF.values()}
    for n in pb.nodes:  # every node runs on the CPU at a small size
        small = dataclasses.replace(n.p, **P_SMALL)
        motif = get_motif(n.motif)
        out = motif.apply(small, motif.make_inputs(small, 0, "cpu"),
                          n.variant)
        assert out and all(isinstance(v, torch.Tensor) for v in out.values())
