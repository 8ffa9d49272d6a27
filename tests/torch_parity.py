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

#: the configs the port builds; the other three raise NotImplementedError
ZOO_BUILDABLE = ("qwen3-4b", "tinyllama-1.1b", "mistral-nemo-12b",
                 "gemma2-9b", "internvl2-1b", "deepseek-v2-lite-16b",
                 "deepseek-v3-671b")
ZOO_UNPORTED = ("mamba2-780m", "recurrentgemma-9b", "whisper-small")
#: the MoE configs (multi-head latent attention and MoE layers)
ZOO_MOE = ("deepseek-v2-lite-16b", "deepseek-v3-671b")


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
