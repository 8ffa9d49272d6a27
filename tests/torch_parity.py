"""Shared helpers for the PyTorch port's parity tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages, so the
JAX reference and the port compute on the same values.  Not a test module:
pytest does not collect it.
"""
from __future__ import annotations

import contextlib
from typing import List, Tuple

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the suite runs with several pytest-xdist workers on a few cores
torch.set_num_threads(1)


def np_rand(seed: int, shape, dtype: str) -> np.ndarray:
    """Random numpy data: uint32/int32 words or standard-normal floats.
    ``bfloat16`` comes back as float32; cast it in each package."""
    rng = np.random.default_rng(seed)
    if dtype in ("uint32", "int32"):
        return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
            np.uint32).view(dtype)
    return rng.standard_normal(shape).astype(np.float32)


def to_torch(a: np.ndarray, dtype: str = "") -> torch.Tensor:
    """A CPU tensor of ``a`` (cast to ``dtype`` when given)."""
    t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(getattr(torch, dtype)) if dtype else t


def to_jax(a: np.ndarray, dtype: str = ""):
    import jax.numpy as jnp

    return jnp.asarray(a, getattr(jnp, dtype)) if dtype else jnp.asarray(a)


def as_np(x) -> np.ndarray:
    """numpy view of a jax array or tensor; bfloat16 widened to float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def jax_tree_to_numpy(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def torch_tree_to_jax(tree: dict) -> dict:
    """The same values as JAX arrays, dtypes kept (bfloat16 included)."""
    return {k: to_jax(as_np(t), str(t.dtype).replace("torch.", ""))
            for k, t in tree.items()}


def tree_structure(tree: dict) -> dict:
    """key -> (shape, dtype name) of a dict of tensors or (abstract) arrays."""
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


def assert_trees_close(want, got, rtol: float, atol: float) -> None:
    """Every leaf of a reference output dict against the port's, by key."""
    assert set(want) == set(got), (sorted(want), sorted(got))
    for k in want:
        w, g = as_np(want[k]), as_np(got[k])
        assert w.shape == g.shape, (k, w.shape, g.shape)
        if rtol == 0 and atol == 0:
            np.testing.assert_array_equal(w, g, err_msg=k)
        else:
            np.testing.assert_allclose(w.astype(np.float64),
                                       g.astype(np.float64), rtol=rtol,
                                       atol=atol, err_msg=k)


class KernelOps(TorchDispatchMode):
    """Records the names of the ``repro_torch`` kernel ops a run calls
    (their plain versions, on CPU tensors)."""

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "repro_torch":
            self.ops.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.fixture
def cuda_device() -> torch.device:
    """The CUDA device, or a skip where there is none (decided here, at
    run time, never while the test module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU "
                    "(python3 chip_smoke.py checks them there)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# the model zoo: one config in both packages, the same weights
# ---------------------------------------------------------------------------

#: the configs the port builds: all ten of the zoo
ZOO_BUILDABLE = ("qwen3-4b", "tinyllama-1.1b", "mistral-nemo-12b",
                 "gemma2-9b", "internvl2-1b", "deepseek-v2-lite-16b",
                 "deepseek-v3-671b", "mamba2-780m", "recurrentgemma-9b",
                 "whisper-small")
#: the MoE configs (multi-head latent attention and MoE layers)
ZOO_MOE = ("deepseek-v2-lite-16b", "deepseek-v3-671b")
#: the configs whose prefill caches differ from the reference's on purpose
#: (ROADMAP queue 3 item 18): a recurrent conv tail (Mamba-2, RG-LRU), and
#: Whisper's cross K/V, which ``pad_caches`` leaves at the memory's length
ZOO_RECURRENT = ("mamba2-780m", "recurrentgemma-9b")
ZOO_ITEM_18 = ZOO_RECURRENT + ("whisper-small",)


def extra_inputs(cfg, rng, batch: int, seq: int) -> dict:
    """The numpy inputs beside ``tokens`` (B, seq) a config's batch
    carries: a VLM's ``patch_embeds`` or an encoder-decoder's ``frames``
    (``seq // encoder_downsample`` of them), normal at 0.02 in f32 (each
    package casts them)."""
    if cfg.frontend == "vision_patches":
        shape = (batch, cfg.frontend_tokens, cfg.d_model)
        key = "patch_embeds"
    elif cfg.is_encoder_decoder:
        shape = (batch, max(seq // cfg.encoder_downsample, 1), cfg.d_model)
        key = "frames"
    else:
        return {}
    return {key: (rng.standard_normal(shape) * 0.02).astype(np.float32)}


def text_offset(cfg, extra: dict) -> int:
    """The positions a config's extra inputs take before the text's (a
    VLM's patches; frames are the encoder's, not the decoder's)."""
    return cfg.frontend_tokens if "patch_embeds" in extra else 0


def ref_conv_tail(x, width: int):
    """The last ``width - 1`` rows of a reference array ``x`` (B, S, C),
    left-padded with zeros when S is shorter."""
    import jax.numpy as jnp

    t = x[:, -(width - 1):]
    pad = width - 1 - t.shape[1]
    return jnp.pad(t, ((0, 0), (pad, 0), (0, 0))) if pad > 0 else t


@contextlib.contextmanager
def reference_conv_inputs():
    """While active, the reference's Mamba-2 and RG-LRU blocks return, in a
    prefill's cache, ``conv_in`` beside ``conv``: the last ``W - 1`` rows
    of the conv's *input* (the projection before ``causal_conv1d``),
    left-padded with zeros, computed as the reference's block computes
    that projection.  That is what the port caches as ``conv`` (ROADMAP
    queue 3 item 18).  :func:`split_conv_inputs` takes the two apart."""
    import jax.numpy as jnp

    from repro.models import mamba2 as RM2, rglru as RG

    ssd_orig, lru_orig = RM2.ssd_block_apply, RG.rglru_block_apply

    def ssd(p, cfg, x, **kw):
        out, nc = ssd_orig(p, cfg, x, **kw)
        if kw.get("want_cache") and kw.get("index") is None:
            _, d_in, _, conv_dim = RM2._dims(cfg)
            proj = jnp.einsum("bsd,dp->bsp", x,
                              p["win"].astype(jnp.dtype(cfg.dtype)))
            nc = dict(nc, conv_in=ref_conv_tail(
                proj[..., d_in:d_in + conv_dim], cfg.ssm.conv_width))
        return out, nc

    def lru(p, cfg, x, **kw):
        out, nc = lru_orig(p, cfg, x, **kw)
        if kw.get("want_cache") and kw.get("index") is None:
            x1 = jnp.einsum("bsd,dw->bsw", x,
                            p["w1"].astype(jnp.dtype(cfg.dtype)))
            nc = dict(nc, conv_in=ref_conv_tail(x1, cfg.rglru.conv_width))
        return out, nc

    RM2.ssd_block_apply, RG.rglru_block_apply = ssd, lru
    try:
        yield
    finally:
        RM2.ssd_block_apply, RG.rglru_block_apply = ssd_orig, lru_orig


def split_conv_inputs(tree):
    """A cache tree made under :func:`reference_conv_inputs` -> (the
    reference's own caches, the caches with ``conv`` replaced by
    ``conv_in``: what the port's prefill caches)."""
    if not isinstance(tree, dict):
        return tree, tree
    if "conv_in" in tree:
        own = {k: v for k, v in tree.items() if k != "conv_in"}
        return own, dict(own, conv=tree["conv_in"])
    pairs = {k: split_conv_inputs(v) for k, v in tree.items()}
    return ({k: a for k, (a, _) in pairs.items()},
            {k: b for k, (_, b) in pairs.items()})


def no_drop_capacity(moe) -> float:
    """A ``capacity_factor`` at which every group of ``Tg`` tokens gets
    ``_capacity(moe, Tg) >= Tg`` slots an expert, so no assignment is
    dropped: ``E / k`` and a little."""
    return moe.num_experts / moe.experts_per_token + 0.01


def zoo_pair(name: str, dtype: str = "float32", *, layers: int = 2,
             seed: int = 0, no_drop: bool = False, **overrides):
    """``reduced(get_config(name), layers=layers)`` at compute ``dtype`` in
    both packages, built, with the reference's weights from ``seed``
    handed to the port: ``(ref_model, ref_params, port_model,
    port_params)``.  ``no_drop`` sets an MoE config's capacity factor to
    :func:`no_drop_capacity` in both."""
    import dataclasses

    import jax

    from repro.configs import get_config as ref_get, reduced as ref_reduced
    from repro.models import build_model as ref_build
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import model_params_from_reference
    from repro_torch.models import build_model

    rcfg = ref_reduced(ref_get(name), layers=layers).replace(
        dtype=dtype, **overrides)
    cfg = reduced(get_config(name), layers=layers).replace(
        dtype=dtype, **overrides)
    if no_drop:
        rcfg = rcfg.replace(moe=dataclasses.replace(
            rcfg.moe, capacity_factor=no_drop_capacity(rcfg.moe)))
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=no_drop_capacity(cfg.moe)))
    rm, m = ref_build(rcfg), build_model(cfg)
    rp = rm.init(jax.random.key(seed))
    return rm, rp, m, model_params_from_reference(jax_tree_to_numpy(rp),
                                                  "cpu")


def flat(tree, prefix: str = "") -> dict:
    """Nested dicts -> {"a/b/c": leaf}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def bf16_tol(want) -> dict:
    """The bf16 tolerance of the zoo's parity tests: ``rtol`` one bf16
    rounding (2^-7) and ``atol`` a tenth of the reference output's
    standard deviation.  Measured on the reduced configs (two layers, seed
    0): the port's forward, prefill, cache and decode outputs lie within
    4.6 % of that deviation of the reference's; each product and norm
    rounds to bf16 in both packages, at sums taken in another order."""
    return dict(rtol=2.0 ** -7, atol=0.1 * float(np.std(as_np(want))))


#: the f32 tolerance of the zoo's parity tests (measured: 4e-6 at most)
F32_TOL = dict(rtol=1e-4, atol=1e-4)


def zoo_tol(dtype: str, want) -> dict:
    return F32_TOL if dtype == "float32" else bf16_tol(want)


def zoo_close(got, want, dtype: str, msg: str = "") -> None:
    """``got`` against the reference's ``want`` at :func:`zoo_tol`."""
    np.testing.assert_allclose(as_np(got), as_np(want),
                               **zoo_tol(dtype, as_np(want)), err_msg=msg)


# ---------------------------------------------------------------------------
# MoE routing: what each package's router chose, to tell a near-tie flip
# from a fault
# ---------------------------------------------------------------------------


def kept_experts(top_ids: np.ndarray, mo, capacity: int,
                 groups: int) -> np.ndarray:
    """Each token's kept experts, (T, k) ascending with -1 for an
    assignment the capacity dropped, for routing ``top_ids`` (T, k) under
    the sort dispatch of ``groups`` equal groups."""
    from repro_torch.models.layers import _dispatch_groups

    T, k = top_ids.shape
    ids = torch.from_numpy(top_ids.astype(np.int64)).reshape(groups, -1, k)
    _, slot, st, _, _ = _dispatch_groups(
        torch.zeros(ids.shape[:2] + (1,)), torch.zeros(ids.shape), ids, mo,
        capacity)
    E, C = mo.num_experts, capacity
    expert = torch.where(slot < E * C, slot // C, -1)
    perm = torch.argsort(st, dim=-1, stable=True)
    return np.sort(expert.gather(1, perm).reshape(T, k).numpy(), axis=-1)


@contextlib.contextmanager
def record_moe_routes():
    """While active, every MoE layer call of either package records its
    router's f32 logits (T, E), its top-k experts (T, k) ascending and
    :func:`kept_experts` (T, k), tokens in (B, S) order, in
    ``routes["ref"]`` and ``routes["port"]``, one entry a call.  The routing is recomputed beside the layer from its input, by
    the reference's formulas in each package, so a fault inside the
    layer is not recorded as a routing choice."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from repro.models import layers as RL
    from repro_torch.models import layers as L

    routes = {"ref": [], "port": []}
    ref_orig, port_orig = RL.moe_apply, L.moe_apply

    def shape(mo, x):
        T = x.shape[0] * x.shape[1]
        Tg = min(mo.group_size, T)
        return T, T // Tg, L._capacity(mo, Tg)

    def port_moe(p, cfg, x):
        mo = cfg.moe
        T, G, C = shape(mo, x)
        logits = x.reshape(G, T // G, -1).to(torch.float32) @ p["router"].to(
            torch.float32)
        top = torch.topk(torch.softmax(logits, dim=-1),
                         mo.experts_per_token, dim=-1).indices
        top = top.reshape(T, -1).numpy()
        routes["port"].append((logits.reshape(T, -1).numpy(),
                               np.sort(top, axis=-1),
                               kept_experts(top, mo, C, G)))
        return port_orig(p, cfg, x)

    def ref_moe(p, cfg, x):
        mo = cfg.moe
        T, G, C = shape(mo, x)
        logits = jnp.einsum("gtd,de->gte",
                            x.reshape(G, T // G, -1).astype(jnp.float32),
                            p["router"].astype(jnp.float32))
        _, top = lax.top_k(jax.nn.softmax(logits, axis=-1),
                           mo.experts_per_token)

        def put(lg, ti):
            ti = np.asarray(ti).reshape(T, -1)
            routes["ref"].append((np.asarray(lg).reshape(T, -1),
                                  np.sort(ti, axis=-1),
                                  kept_experts(ti, mo, C, G)))

        jax.debug.callback(put, logits, top)
        return ref_orig(p, cfg, x)

    RL.moe_apply, L.moe_apply = ref_moe, port_moe
    try:
        yield routes
        jax.effects_barrier()
    finally:
        RL.moe_apply, L.moe_apply = ref_orig, port_orig


def routing_flips(want, got) -> Tuple[np.ndarray, List[str]]:
    """Tokens whose kept experts differ between two runs over the same
    tokens: ``want`` and ``got`` are lists of :func:`record_moe_routes`
    entries, one a MoE layer, aligned token for token.  Returns the (T,)
    mask of such tokens and a line for each: its experts in both runs and
    ``want``'s gap between its k-th and (k+1)-th choice, in router
    probability and in logit, beside the largest router-logit difference
    between the runs.  A router flip must lie at a near tie: its logit
    gap under twice that difference.  A token whose choice agrees but
    whose kept experts differ must share its layer call with a flip that
    moved an expert's count (capacity).  Either failing raises, and so do
    more such tokens than a quarter of them (or one): a flip is a near
    tie, and rare."""
    assert len(want) == len(got), (len(want), len(got))
    T = want[0][1].shape[0] if want else 0
    mask = np.zeros(T, bool)
    notes = []
    for layer, ((wl, wt, wk), (gl, gt, gk)) in enumerate(zip(want, got)):
        flips = (wt != gt).any(-1)
        drops = (wk != gk).any(-1) & ~flips
        noise = float(np.abs(wl - gl).max())
        k = wt.shape[1]
        for t in np.flatnonzero(flips):
            lg = np.sort(wl[t])[::-1]
            pr = np.exp(lg - lg[0])
            pr /= pr.sum()
            notes.append(
                f"MoE layer {layer}, token {t}: router flip {wt[t].tolist()} "
                f"-> {gt[t].tolist()}; k-th minus (k+1)-th choice: "
                f"probability {pr[k - 1] - pr[k]:.3g}, logit "
                f"{lg[k - 1] - lg[k]:.3g} (largest router-logit difference "
                f"{noise:.3g})")
            assert lg[k - 1] - lg[k] <= 2 * noise, notes[-1]
        for t in np.flatnonzero(drops):
            notes.append(f"MoE layer {layer}, token {t}: same choice, kept "
                         f"{wk[t].tolist()} -> {gk[t].tolist()} (capacity)")
            assert flips.any(), notes[-1]
        mask |= flips | drops
    assert mask.sum() <= max(1, T // 4), "\n".join(notes)
    return mask, notes


def assert_rows_close(got, want, tol: dict, skip=None, notes=()) -> None:
    """``got`` against ``want`` (..., V) at ``tol``, leaving out the rows
    ``skip`` (a bool mask of the leading dims) marks: tokens whose MoE
    routing differs between the runs (:func:`routing_flips`, whose
    ``notes`` go into the message)."""
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    skip = (np.zeros(want.shape[:-1], bool) if skip is None
            else np.asarray(skip).reshape(want.shape[:-1]))
    msg = "\n".join(notes)
    np.testing.assert_allclose(got[~skip], want[~skip], **tol, err_msg=msg)


# ---------------------------------------------------------------------------
# one block of the zoo in both packages, and serving against the forward
# ---------------------------------------------------------------------------


def block_params(meta_fn, rcfg, seed: int = 0, jitter: float = 0.1):
    """A reference block's params from ``meta_fn(rcfg)`` at ``seed``, each
    leaf moved by ``jitter`` x a standard normal draw (so biases, gates
    and scales are not their zeros and ones), as (numpy tree for the
    reference, the port's tree on the CPU)."""
    import jax

    from repro.models.params import init_params
    from repro_torch.convert import model_params_from_reference

    rng = np.random.default_rng(seed)
    tree = jax_tree_to_numpy(init_params(jax.random.key(seed),
                                         meta_fn(rcfg)))

    def move(t):
        if isinstance(t, dict):
            return {k: move(t[k]) for k in sorted(t)}
        return (t + jitter * rng.standard_normal(t.shape)).astype(t.dtype)

    tree = move(tree)
    return tree, model_params_from_reference(tree, "cpu")


def serve_teacher_forced(rm, rp, m, p, *, batch: int, prompt: int,
                         steps: int, seed: int = 0):
    """The port's prefill of ``prompt`` tokens, its ``pad_caches`` to
    ``prompt + steps`` and ``steps - 1`` decode steps fed the next tokens
    of a random sequence, against the reference's jitted forward over the
    whole sequence.  Returns (each position's port logits (B, V), from
    position ``prompt - 1`` on; the forward's logits at those positions
    (B, steps, V) numpy; a copy of the port's prefill caches; the padded
    ones, as the decode steps left them)."""
    import jax
    import jax.numpy as jnp

    from repro_torch.models.params import tree_map
    from repro_torch.runtime import pad_caches

    cfg = m.cfg
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, cfg.vocab_size,
                       (batch, prompt + steps - 1)).astype(np.int32)
    extra = extra_inputs(cfg, rng, batch, prompt)
    off = text_offset(cfg, extra)
    textra = {k: torch.from_numpy(v) for k, v in extra.items()}
    logits, caches = m.prefill(p, {"tokens": torch.from_numpy(
        seq[:, :prompt]), **textra})
    prefilled = tree_map(torch.clone, caches)
    padded = pad_caches(m, caches, batch, off + prompt + steps)
    got, c = [logits[:, 0]], padded
    for i in range(steps - 1):
        logits, c = m.decode(p, c, {
            "tokens": torch.from_numpy(seq[:, prompt + i:prompt + i + 1]),
            "index": torch.tensor(off + prompt + i, dtype=torch.int32)})
        got.append(logits[:, 0])
    want, _ = jax.jit(rm.forward)(rp, {
        "tokens": jnp.asarray(seq),
        **{k: jnp.asarray(v) for k, v in extra.items()}})
    return got, as_np(want)[:, prompt - 1:], prefilled, padded


# ---------------------------------------------------------------------------
# training: one batch in both packages, the loss and its gradients
# ---------------------------------------------------------------------------


def zoo_train_batch(cfg, seed: int, batch: int, seq: int,
                    ignored: int = 3) -> dict:
    """A numpy training batch for ``cfg``: ``tokens`` and ``labels`` (B,
    seq) int32 uniform over the vocabulary, the first ``ignored`` labels
    of row 0 set to -1 (masked), and the config's extra inputs
    (:func:`extra_inputs`)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels[0, :ignored] = -1
    return {"tokens": toks, "labels": labels,
            **extra_inputs(cfg, rng, batch, seq)}


def ref_loss_and_grads(rm, rp, batch: dict, remat: bool = False):
    """The reference's jitted ``value_and_grad`` of ``Model.loss``:
    (loss, metrics, grads as a flat dict of numpy arrays)."""
    import jax
    import jax.numpy as jnp

    fn = jax.jit(jax.value_and_grad(
        lambda p_, b_: rm.loss(p_, b_, remat=remat), has_aux=True))
    (loss, metrics), grads = fn(rp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            flat(jax_tree_to_numpy(grads)))


def port_loss_and_grads(m, p, batch: dict, remat: bool = True):
    """The port's ``Model.loss`` and ``torch.autograd.grad`` over every
    param leaf: (loss, metrics, grads as a flat dict of tensors)."""
    from repro_torch.models.params import tree_leaves, tree_map

    leaves = tree_map(lambda t: t.detach().requires_grad_(True), p)
    loss, metrics = m.loss(leaves, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    loss, metrics = loss.detach(), {k: v.detach() for k, v in metrics.items()}
    # tree_map's dicts list their keys sorted: flat() walks them in the
    # order of tree_leaves
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            dict(zip(flat(leaves), grads)))
