"""The port's optimiser (``repro_torch.optim``) against the JAX package's
``repro.optim`` on the same numpy trees: the LR schedules, AdamW's state
metadata, global norm, clipping and update (f32 and bf16 leaves, several
steps, with and without clipping and a schedule), error-feedback top-k
with ties at the threshold and its residuals, and int8 round trips.
f32 at ``rtol=1e-6`` and ``atol=1e-8``: the same arithmetic, but XLA and
ATen sum a leaf's squares (the global norm) in other orders and compute
``cos`` by other formulas, an f32 rounding apart (measured: relative
2.2e-7); a moment that cancels toward zero over the steps carries that
rounding at 1.3e-6 of its size, 2.6e-9 absolute.  Integers, int8 round
trips and bf16 leaves exact."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_np, flat

from repro import optim as R
from repro.models.params import ParamMeta as RefMeta
from repro_torch import optim as P
from repro_torch.models.params import ParamMeta, tree_map

TOL = dict(rtol=1e-6, atol=1e-8)

#: a small tree of every leaf kind: f32 matrices and a vector, a bf16 leaf
SHAPES = {"a": ((3, 4), "float32"),
          "b": {"c": ((5,), "float32"), "d": ((2, 3), "bfloat16")},
          "w": ((6, 8), "float32")}


def _np_tree(seed: int, scale: float = 1.0):
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        shape, dt = t
        return ((rng.standard_normal(shape) * scale).astype(np.float32), dt)
    return walk(SHAPES)


def _both(tree):
    """(the reference's tree of jnp arrays, the port's of tensors), each
    leaf cast to its dtype in each package from the same f32 values."""
    def ref(t):
        if isinstance(t, dict):
            return {k: ref(v) for k, v in t.items()}
        return jnp.asarray(t[0], getattr(jnp, t[1]))

    def port(t):
        if isinstance(t, dict):
            return {k: port(v) for k, v in t.items()}
        return torch.from_numpy(t[0].copy()).to(getattr(torch, t[1]))
    return ref(tree), port(tree)


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _close(got, want, tol=TOL):
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        gk, wk = g[k], w[k]
        assert _dtype(gk) == _dtype(wk), k
        if gk.dtype in (torch.bfloat16, torch.int32, torch.int8):
            np.testing.assert_array_equal(as_np(gk), as_np(wk), err_msg=k)
        else:
            np.testing.assert_allclose(as_np(gk), as_np(wk), **tol,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["warmup_cosine", "warmup_linear"])
@pytest.mark.parametrize("warmup,total,floor", [(10, 100, None), (0, 7, 0.3),
                                                (5, 5, 0.0), (20, 60, 0.1)])
def test_schedule_matches_the_reference(kind, warmup, total, floor):
    kw = {} if floor is None else {"floor": floor}
    ref = getattr(R, kind)(warmup, total, **kw)
    port = getattr(P, kind)(warmup, total, **kw)
    steps = np.arange(0, total + 15, dtype=np.int32)
    want = np.array([float(ref(jnp.asarray(s))) for s in steps], np.float32)
    got = port(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_lr_at_with_and_without_a_schedule():
    step = np.int32(7)
    for kw in ({}, {"schedule_args": (4, 20)}):
        args = kw.get("schedule_args")
        rc = R.AdamWConfig(lr=3e-3, schedule=(R.warmup_cosine(*args)
                                              if args else None))
        pc = P.AdamWConfig(lr=3e-3, schedule=(P.warmup_cosine(*args)
                                              if args else None))
        got = pc.lr_at(torch.tensor(step))
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == float(rc.lr_at(jnp.asarray(step)))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_adamw_init_meta_mirrors_the_reference():
    ref_pm = {"x": RefMeta((3, 4), jnp.float32, ("embed", "mlp"), "scaled",
                           3),
              "y": {"z": RefMeta((2,), jnp.bfloat16, (None,), "ones", 0)}}
    pm = {"x": ParamMeta((3, 4), torch.float32, ("embed", "mlp"), "scaled",
                         3),
          "y": {"z": ParamMeta((2,), torch.bfloat16, (None,), "ones", 0)}}
    for md in ("float32", "bfloat16"):
        want = flat(R.adamw_init_meta(ref_pm, R.AdamWConfig(moment_dtype=md)))
        got = flat(P.adamw_init_meta(pm, P.AdamWConfig(moment_dtype=md)))
        assert sorted(got) == sorted(want)
        for k in want:
            w, g = want[k], got[k]
            assert (g.shape, g.axes, g.init, g.fan_in) == (
                w.shape, w.axes, w.init, w.fan_in), k
            assert str(g.dtype).replace("torch.", "") == str(
                np.dtype(w.dtype)), k


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_global_norm_and_clip(scale):
    ref, port = _both(_np_tree(0, scale))
    np.testing.assert_allclose(float(P.global_norm(port)),
                               float(R.global_norm(ref)), **TOL)
    got, gn = P.clip_by_global_norm(port, 1.0)
    want, wn = R.clip_by_global_norm(ref, 1.0)
    np.testing.assert_allclose(float(gn), float(wn), **TOL)
    _close(got, want)


@pytest.mark.parametrize("clip,sched", [(1.0, True), (0.0, False),
                                        (0.5, False)])
def test_adamw_update_matches_the_reference_over_steps(clip, sched):
    rc = R.AdamWConfig(lr=1e-2, grad_clip=clip,
                       schedule=R.warmup_cosine(2, 6) if sched else None)
    pc = P.AdamWConfig(lr=1e-2, grad_clip=clip,
                       schedule=P.warmup_cosine(2, 6) if sched else None)
    rp, pp = _both(_np_tree(1))
    r_state = {"m": jax.tree.map(lambda t: jnp.zeros(t.shape), rp),
               "v": jax.tree.map(lambda t: jnp.zeros(t.shape), rp),
               "step": jnp.zeros((), jnp.int32)}
    p_state = {"m": tree_map(lambda t: torch.zeros(t.shape), pp),
               "v": tree_map(lambda t: torch.zeros(t.shape), pp),
               "step": torch.zeros((), dtype=torch.int32)}
    for i in range(4):
        rg, pg = _both(_np_tree(10 + i, 0.5))
        rp, r_state, r_stats = R.adamw_update(rp, rg, r_state, rc)
        pp, p_state, p_stats = P.adamw_update(pp, pg, p_state, pc)
        _close(pp, rp)
        _close(p_state, r_state)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(p_stats[k]), float(r_stats[k]),
                                       **TOL, err_msg=k)
    assert int(p_state["step"]) == 4 and p_state["step"].dtype == torch.int32


def test_adamw_update_leaves_its_inputs_as_they_were():
    _, pp = _both(_np_tree(1))
    _, pg = _both(_np_tree(2))
    before = tree_map(torch.clone, pp)
    state = {"m": tree_map(torch.zeros_like, pp),
             "v": tree_map(torch.zeros_like, pp),
             "step": torch.zeros((), dtype=torch.int32)}
    new, new_state, _ = P.adamw_update(pp, pg, state, P.AdamWConfig())
    _close(pp, before, dict(rtol=0, atol=0))
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1
    assert not torch.equal(flat(new)["w"], flat(pp)["w"])


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def _tied_tree():
    """Grads with ties at the top-k threshold: k = 2 of 20 entries, three
    entries share the second-largest magnitude (one of them negative)."""
    a = np.linspace(-0.1, 0.1, 20).astype(np.float32)
    a[[3, 7, 11]] = [0.5, -0.5, 0.5]
    a[15] = 0.9
    return {"t": (a.reshape(4, 5), "float32"),
            "u": (np.arange(12, dtype=np.float32).reshape(3, 4) / 7.0,
                  "float32"),
            "h": (np.linspace(-1, 1, 30).astype(np.float32), "bfloat16")}


@pytest.mark.parametrize("ratio", [0.1, 0.3, 1e-6])
def test_ef_topk_matches_the_reference_with_ties(ratio):
    rg, pg = _both(_tied_tree())
    r_state = R.compress_topk_init(rg)
    p_state = P.compress_topk_init(pg)
    _close(p_state.error, r_state.error, dict(rtol=0, atol=0))
    for _ in range(3):  # the residual feeds back
        rk, r_state, rs = R.ef_topk_compress_decompress(rg, r_state, ratio)
        pk, p_state, ps = P.ef_topk_compress_decompress(pg, p_state, ratio)
        _close(pk, rk)
        _close(p_state.error, r_state.error)
        assert float(ps["bytes_fraction"]) == float(rs["bytes_fraction"])
    if ratio == 0.1:  # k = 2 of "t": the 0.9 and all three tied 0.5s kept
        assert int((flat(pk)["t"] != 0).sum()) >= 4


def test_topk_dense_keeps_every_tie():
    x = torch.tensor([0.2, -0.7, 0.7, 0.1, 0.7, -0.3])
    got = P.compression._topk_dense(x, 2)
    want = R.compression._topk_dense(jnp.asarray(x.numpy()), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got != 0).sum()) == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1e-14, 1.0, 300.0])
def test_int8_round_trip_matches_the_reference(dtype, scale):
    x = (np.random.default_rng(5).standard_normal((7, 9)) * scale).astype(
        np.float32)
    x[0, 0] = 0.5 * scale  # a value on a half step after scaling
    xr, xp = jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))
    rq, rs = R.int8_compress(xr)
    pq, ps = P.int8_compress(xp)
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    assert float(ps) == float(rs)
    np.testing.assert_array_equal(P.int8_decompress(pq, ps).numpy(),
                                  np.asarray(R.int8_decompress(rq, rs)))
