"""Generic decoder trunk: the pattern-aware stack of layers (port of
``repro/models/trunk.py``: the ``attn``, ``mla``, ``ssm`` (Mamba-2) and
``recurrent`` (RG-LRU) mixers, with dense or MoE feed-forward layers; a
Mamba-2 block has none).

A config's layers are grouped into *segments*:

* a ``prefix`` of unscanned layers (e.g. DeepSeek's leading dense layers),
* a scanned body: ``count`` iterations of the repeating ``layer_pattern``
  (each pattern position has its own stacked params, with a leading
  ``layers`` dim), and
* an unscanned ``tail`` for pattern remainders.

The parameter and cache trees are the reference's key for key and shape
for shape.  Where the reference runs a scanned segment with ``lax.scan``,
the port runs a Python loop over the ``layers`` dim: each stacked param
leaf is ``unbind``-ed once a segment (so a backward pass stacks the
layers' gradients once, where a slice ``t[i]`` a layer would allocate a
zero gradient the size of the whole stack for each), prefill stacks each
layer's new cache along that dim, and decode writes each layer's K/V (or
recurrent state) into its view of the stacked cache in place.  The MoE
layers' auxiliary losses are summed once, at the end (a dense block adds
no launch for a zero loss, as XLA's fused zeros cost the reference none).
``remat`` recomputes each unscanned block, and each scanned layer, in the
backward pass (``torch.utils.checkpoint``, where the reference wraps them
in ``jax.checkpoint``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2, rglru
from repro_torch.models.params import stack_tree, tree_leaves, tree_map

f32 = torch.float32


# ---------------------------------------------------------------------------
# Segments
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Segment:
    kinds: Tuple[str, ...]   # block kinds applied per step
    count: int               # scan length (1 for unscanned segments)
    scanned: bool
    layer_start: int         # absolute index of first layer in segment


def build_segments(cfg: ModelConfig) -> List[Segment]:
    nl = cfg.num_layers
    if cfg.family == "ssm":
        return [Segment(("ssm",), nl, True, 0)]
    pattern = cfg.layer_pattern
    segs: List[Segment] = []
    start = 0
    if cfg.moe is not None and cfg.moe.first_dense_layers:
        k = min(cfg.moe.first_dense_layers, nl)  # reduced configs may shrink nl
        segs.append(Segment(tuple(pattern[i % len(pattern)] for i in range(k)),
                            1, False, 0))
        start = k
    body = nl - start
    n_super, tail = divmod(body, len(pattern))
    if n_super:
        segs.append(Segment(pattern, n_super, True, start))
    if tail:
        segs.append(Segment(pattern[:tail], 1, False, start + n_super * len(pattern)))
    return segs


def _block_kind(cfg: ModelConfig, kind: str) -> str:
    """Resolve the mixer implementation for a block kind."""
    if kind == "ssm":
        return "ssm"
    if kind == "recurrent":
        return "recurrent"
    return "mla" if cfg.mla is not None else "attn"


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------


def block_meta(cfg: ModelConfig, kind: str, layer_idx: int) -> Dict[str, Any]:
    mixer = _block_kind(cfg, kind)
    m: Dict[str, Any] = {"norm1": L.norm_meta(cfg)}
    if mixer == "ssm":
        m["mixer"] = mamba2.ssd_block_meta(cfg)
        return m  # mamba2 blocks have no separate FFN
    if mixer == "recurrent":
        m["mixer"] = rglru.rglru_block_meta(cfg)
    elif mixer == "mla":
        m["mixer"] = L.mla_meta(cfg)
    else:
        m["mixer"] = L.attn_meta(cfg)
    m["norm2"] = L.norm_meta(cfg)
    if _is_moe_layer(cfg, layer_idx):
        m["ffn"] = L.moe_meta(cfg)
    else:
        width = None
        if cfg.moe is not None:  # the leading dense layers of an MoE config
            width = cfg.moe.dense_d_ff or cfg.d_ff
        m["ffn"] = L.mlp_meta(cfg, width=width)
    if cfg.post_attn_norm:
        m["post_norm1"] = L.norm_meta(cfg)
        m["post_norm2"] = L.norm_meta(cfg)
    return m


def block_cache_meta(cfg: ModelConfig, kind: str, batch: int,
                     seq: int) -> Optional[Dict[str, Any]]:
    mixer = _block_kind(cfg, kind)
    if mixer == "ssm":
        return mamba2.ssd_cache_meta(cfg, batch)
    if mixer == "recurrent":
        return rglru.rglru_cache_meta(cfg, batch)
    if mixer == "mla":
        return L.mla_cache_meta(cfg, batch, seq)
    cache_len = seq
    if kind == "local" and cfg.sliding_window and cfg.sliding_window < seq:
        cache_len = cfg.sliding_window  # ring buffer for local layers
    return L.attn_cache_meta(cfg, batch, cache_len)


def block_apply(
    p, cfg: ModelConfig, x: torch.Tensor, kind: str, *,
    positions: torch.Tensor,
    causal: bool = True,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    index: Optional[torch.Tensor] = None,
    want_cache: bool = False,
    moe_layer: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]], torch.Tensor]:
    """(x, the block's new cache, its auxiliary loss: the MoE layer's, or
    ``None``)."""
    mixer = _block_kind(cfg, kind)
    aux = None

    h = L.norm_apply(p["norm1"], cfg, x)
    if mixer == "ssm":
        a, new_cache = mamba2.ssd_block_apply(
            p["mixer"], cfg, h, cache=cache, index=index,
            want_cache=want_cache)
        return x + a, new_cache, aux
    if mixer == "recurrent":
        a, new_cache = rglru.rglru_block_apply(
            p["mixer"], cfg, h, cache=cache, index=index,
            want_cache=want_cache)
    elif mixer == "mla":
        a, new_cache = L.mla_apply(p["mixer"], cfg, h, positions=positions,
                                   cache=cache, index=index,
                                   want_cache=want_cache)
    else:
        a, new_cache = L.attn_apply(
            p["mixer"], cfg, h, layer_kind=kind, positions=positions,
            causal=causal, cache=cache, index=index, want_cache=want_cache)
    if cfg.post_attn_norm:
        a = L.norm_apply(p["post_norm1"], cfg, a)
    x = x + a

    h = L.norm_apply(p["norm2"], cfg, x)
    if moe_layer:
        f, aux = L.moe_apply(p["ffn"], cfg, h)
    else:
        f = L.mlp_apply(p["ffn"], cfg, h)
    if cfg.post_attn_norm:
        f = L.norm_apply(p["post_norm2"], cfg, f)
    return x + f, new_cache, aux


# ---------------------------------------------------------------------------
# Trunk = segments of blocks
# ---------------------------------------------------------------------------


def trunk_meta(cfg: ModelConfig) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for si, seg in enumerate(build_segments(cfg)):
        entry: Dict[str, Any] = {}
        for j, kind in enumerate(seg.kinds):
            li = seg.layer_start + j
            bm = block_meta(cfg, kind, li)
            entry[f"p{j}"] = stack_tree(bm, seg.count) if seg.scanned else bm
        out[f"seg{si}"] = entry
    return out


def trunk_cache_meta(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for si, seg in enumerate(build_segments(cfg)):
        entry: Dict[str, Any] = {}
        for j, kind in enumerate(seg.kinds):
            cm = block_cache_meta(cfg, kind, batch, seq)
            entry[f"p{j}"] = stack_tree(cm, seg.count) if seg.scanned else cm
        out[f"seg{si}"] = entry
    return out


def _is_moe_layer(cfg: ModelConfig, layer_idx: int) -> bool:
    return cfg.moe is not None and layer_idx >= cfg.moe.first_dense_layers


def unstack(tree) -> List[Dict[str, Any]]:
    """A stacked tree as one tree a layer: every leaf ``unbind``-ed along
    its leading ``layers`` dim once."""
    leaves = tree_map(lambda t: t.unbind(0), tree)
    n = len(tree_leaves(leaves)[0])
    return [tree_map(lambda ts, i=i: ts[i], leaves) for i in range(n)]


def maybe_remat(fn, remat: bool):
    """``fn``, recomputed in the backward pass when ``remat``
    (``torch.utils.checkpoint``, non-reentrant; the zoo draws nothing at
    random, so no RNG state is kept)."""
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                    preserve_rng_state=False)


def trunk_apply(
    params, cfg: ModelConfig, x: torch.Tensor, *,
    positions: torch.Tensor,
    causal: bool = True,
    caches: Optional[Dict[str, Any]] = None,
    index: Optional[torch.Tensor] = None,
    want_cache: bool = False,
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], torch.Tensor]:
    """Run all segments.  Returns (x, new_caches|None, aux_loss).  Decode
    (``caches`` and ``index``) writes into ``caches``' tensors and returns
    them.  ``remat`` recomputes each unscanned block and each scanned
    layer in the backward pass."""
    segs = build_segments(cfg)
    keep_cache = want_cache or index is not None
    new_caches: Dict[str, Any] = {}
    auxs: List[torch.Tensor] = []  # the MoE layers' losses, layer by layer

    def run(kinds, layer_start):
        """One layer (a scanned segment's) or one block (an unscanned
        segment's): ``kinds`` applied in turn, ``(p_list, x, c_list)`` ->
        ``(x, new caches, aux losses)``, each list one entry a kind."""
        def layer(ps, x_, cs):
            ncs, aux_l = [], []
            for j, kind in enumerate(kinds):
                x_, nc, aux = block_apply(
                    ps[j], cfg, x_, kind, positions=positions,
                    causal=causal, cache=None if cs is None else cs[j],
                    index=index, want_cache=want_cache,
                    moe_layer=_is_moe_layer(cfg, layer_start + j))
                ncs.append(nc)
                aux_l += [aux] if aux is not None else []
            return x_, ncs, aux_l
        return maybe_remat(layer, remat)

    for si, seg in enumerate(segs):
        seg_p = params[f"seg{si}"]
        seg_c = caches[f"seg{si}"] if caches is not None else None
        keys = [f"p{j}" for j in range(len(seg.kinds))]

        if not seg.scanned:
            entry_caches = {}
            for j, (key, kind) in enumerate(zip(keys, seg.kinds)):
                x, (entry_caches[key],), aux = run(
                    (kind,), seg.layer_start + j)(
                        [seg_p[key]], x,
                        None if seg_c is None else [seg_c[key]])
                auxs += aux
            if keep_cache:
                new_caches[f"seg{si}"] = entry_caches
            continue

        # scanned segment: layer i is entry i of every unbound leaf -------
        layer = run(seg.kinds, seg.layer_start)
        per_layer: List[Dict[str, Any]] = []
        for i, p_i in enumerate(unstack(seg_p)):
            c_i = (None if seg_c is None
                   else [tree_map(lambda t: t[i], seg_c[k]) for k in keys])
            x, ncs, aux = layer([p_i[k] for k in keys], x, c_i)
            auxs += aux
            per_layer.append(dict(zip(keys, ncs)))
        if seg_c is not None and index is not None:
            new_caches[f"seg{si}"] = seg_c  # written in place, slice by slice
        elif keep_cache:
            new_caches[f"seg{si}"] = tree_map(
                lambda *ts: torch.stack(ts), *per_layer)

    aux_total = (torch.stack(auxs).sum() if auxs
                 else torch.zeros((), dtype=f32, device=x.device))
    return x, (new_caches if keep_cache else None), aux_total
