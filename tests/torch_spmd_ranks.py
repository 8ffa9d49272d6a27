"""What each rank of the gloo groups in ``test_torch_spmd_values.py`` runs
(a module of its own: a spawned rank imports it, and it imports only
``repro_torch``, never JAX).

Every function here runs the zoo's DTensor paths on real values over
``make_host_mesh(model_axis)`` and returns, on every rank, what the plain
one-rank path returns for the same inputs, gathered whole as numpy."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.train import reduce_config
from repro_torch.models import build_model
from repro_torch.models.params import ParamMeta, tree_leaves, tree_map

#: the reduced configs the tests serve: f32 compute, a window of 8 where
#: the config has one, so that a few decode steps wrap its ring caches,
#: and MoE groups of 12 tokens, so that a prefill's groups split over
#: ``data``
REDUCE = 16


def serve_config(arch: str):
    cfg = reduce_config(get_config(arch), REDUCE).replace(dtype="float32")
    if cfg.sliding_window:
        cfg = cfg.replace(sliding_window=8)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, group_size=12))
    return cfg


def serve_inputs(arch: str, batch: int, prompt: int, steps: int):
    """The params (seed 0), the prompt and the decoded tokens (numpy seed
    1) of :func:`serve_run`."""
    cfg = serve_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt + steps)).astype(np.int32))
    return cfg, model, params, toks


@contextlib.contextmanager
def _on(mesh, cfg):
    """The config's rules on ``mesh`` and DTensor's fallback for ops it
    cannot place, as ``launch.train`` runs a step (nothing without a
    mesh)."""
    from repro_torch.distributed.sharding import ShardingRules, use_mesh
    from repro_torch.distributed.spmd import ReplicateUnplaceable

    if mesh is None:
        yield
        return
    rules = ShardingRules().with_overrides(dict(cfg.sharding_overrides))
    with use_mesh(mesh, rules), ReplicateUnplaceable():
        yield


def _numpy(tree) -> List[np.ndarray]:
    from repro_torch.distributed.sharding import whole

    # copies: a plain leaf's storage is its own, and decode writes caches
    # in place
    return [whole(x).cpu().numpy().copy() for x in tree_leaves(tree)
            if x is not None]


def serve_run(arch: str, model_axis: Optional[int], batch: int = 4,
              prompt: int = 12, steps: int = 6) -> Dict[str, Any]:
    """Prefill ``prompt`` tokens, then decode ``steps`` more one at a time
    into caches of ``prompt + steps`` positions: the prefill's logits and
    caches, and each decode step's logits and the final caches, as numpy.
    With ``model_axis`` the run is on this rank's group, each input placed
    as the dry run places it (``sharding_for_meta``, the batch on
    ``data``); the decode starts from the caches the plain path padded
    (gathered and placed anew), so that each phase is held on its own.
    ``None``: the plain path, in one process."""
    from repro_torch.distributed.sharding import (place, sharding_for_meta,
                                                  whole)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.serve_loop import (make_decode_step,
                                                make_prefill_step,
                                                pad_caches)

    cfg, model, params, toks = serve_inputs(arch, batch, prompt, steps)
    mesh = None if model_axis is None else make_host_mesh(model_axis,
                                                          device="cpu")

    def placed(x, meta: ParamMeta):
        if mesh is None or x is None:
            return x
        return place(x, *sharding_for_meta(meta, mesh))

    def placed_tree(tree, meta_tree):
        return tree_map(lambda x, m: placed(x, m), tree, meta_tree)

    def tok_meta(n):
        return ParamMeta((batch, n), torch.int32, ("batch", None), "zeros")

    idx_meta = ParamMeta((), torch.int32, (), "zeros")
    out: Dict[str, Any] = {}
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    with torch.no_grad(), _on(mesh, cfg):
        p = placed_tree(params, model.param_meta())
        logits, caches = prefill(p, {"tokens": placed(
            toks[:, :prompt], tok_meta(prompt))})
        out["prefill_logits"] = _numpy(logits)
        out["prefill_caches"] = _numpy(caches)
        caches = tree_map(lambda x: None if x is None else whole(x), caches)
        caches = pad_caches(model, caches, batch, prompt + steps)
        caches = placed_tree(caches, model.cache_meta(batch, prompt + steps))
        out["decode_logits"] = []
        for i in range(prompt, prompt + steps):
            logits, caches = decode(p, caches, {
                "tokens": placed(toks[:, i:i + 1], tok_meta(1)),
                "index": placed(torch.tensor(i, dtype=torch.int32),
                                idx_meta)})
            out["decode_logits"].append(_numpy(logits)[0])
        out["decode_caches"] = _numpy(caches)
    return out


def decode_attention_run(model_axis: Optional[int]) -> Dict[str, Any]:
    """``layers.decode_attention`` and ``spmd.index_copy_`` on caches of 16
    positions (4 sequences, 4 query heads over 2 KV heads, head dim 8;
    numpy seed 2), split by position over ``model`` and by sequence over
    ``data`` (``None``: plain tensors): the cache after writing a new
    row at each slot in turn, and the attention at each index, over the
    whole cache, a linear cache with a window of 5 (the window's slice),
    and a ring of 16 with a window of 16 and explicit positions."""
    from repro_torch.distributed.sharding import place, whole
    from repro_torch.distributed.spmd import index_copy_
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import decode_attention
    from torch.distributed.tensor import Replicate, Shard

    B, S, Hkv, G, D = 4, 16, 2, 2, 8
    rng = np.random.default_rng(2)

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    k, v, rows = arr(B, S, Hkv, D), arr(B, S, Hkv, D), arr(S, B, 1, Hkv, D)
    qs = arr(S, B, 1, Hkv * G, D)
    mesh = None if model_axis is None else make_host_mesh(model_axis,
                                                          device="cpu")

    def cache(t):
        if mesh is None:
            return t.clone()
        return place(t, mesh, (Shard(0), Shard(1)))

    def q_of(t):
        return t if mesh is None else place(t, mesh, (Shard(0), Replicate()))

    out: Dict[str, Any] = {"written": [], "full": [], "window": [],
                           "ring": []}
    kc = cache(k)
    for slot in range(S):
        kc = index_copy_(kc, 1, torch.tensor([slot]), q_of(rows[slot]))
        out["written"].append(_numpy(kc)[0])
    kc, vc = cache(k), cache(v)
    for i in range(S):
        index = torch.tensor(i)
        out["full"].append(whole(decode_attention(
            q_of(qs[i]), kc, vc, index=index)).numpy())
        out["window"].append(whole(decode_attention(
            q_of(qs[i]), kc, vc, index=index, window=5,
            softcap=30.0)).numpy())
        # a ring of 16 after 16 + i tokens: slot j holds the newest
        # position congruent to j
        at = S + i
        ring = at - torch.remainder(at - torch.arange(S), S)
        out["ring"].append(whole(decode_attention(
            q_of(qs[i]), kc, vc, index=torch.tensor(at), positions=ring,
            window=S)).numpy())
    return out


def moe_run(model_axis: Optional[int], batch: int = 4) -> Dict[str, Any]:
    """``layers.moe_apply`` of the serving config of deepseek-v2-lite-16b
    (an MoE layer's params, seed 0) on ``batch`` x 12 tokens in groups of
    12 (numpy seed 3), forward and backward: the output, the input's
    gradient and the weights' gradients, whole.  With ``model_axis`` the
    params are placed by ``sharding_for_meta`` (the experts over
    ``model``) and the tokens on ``data``, under the group's mesh; groups
    that do not divide the data axis run whole on each of its ranks."""
    from repro_torch.distributed.sharding import place, sharding_for_meta
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.params import init_params

    cfg = serve_config("deepseek-v2-lite-16b")
    meta = L.moe_meta(cfg)
    params = init_params(meta, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(
        (batch, 12, cfg.d_model)).astype(np.float32))
    mesh = None if model_axis is None else make_host_mesh(model_axis,
                                                          device="cpu")
    if mesh is not None:
        params = tree_map(lambda t, m: place(t, *sharding_for_meta(m, mesh)),
                          params, meta)
        x = place(x, *sharding_for_meta(ParamMeta(
            tuple(x.shape), x.dtype, ("batch", None, None), "zeros"), mesh))
    with _on(mesh, cfg):
        params = tree_map(lambda t: t.detach().requires_grad_(), params)
        x = x.detach().requires_grad_()
        y, aux = L.moe_apply(params, cfg, x)
        ((y * y).sum() + aux).backward()
    return {"out": _numpy(y), "aux": _numpy(aux), "dx": _numpy(x.grad),
            "dparams": _numpy(tree_map(lambda t: t.grad, params))}
