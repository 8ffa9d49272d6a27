"""Generic decoder trunk: the pattern-aware stack of layers (port of
``repro/models/trunk.py`` for the ``attn`` and ``mla`` mixers, with dense
or MoE feed-forward layers).

A config's layers are grouped into *segments*:

* a ``prefix`` of unscanned layers (e.g. DeepSeek's leading dense layers),
* a scanned body: ``count`` iterations of the repeating ``layer_pattern``
  (each pattern position has its own stacked params, with a leading
  ``layers`` dim), and
* an unscanned ``tail`` for pattern remainders.

The parameter and cache trees are the reference's key for key and shape
for shape.  Where the reference runs a scanned segment with ``lax.scan``,
the port runs a Python loop over views of the ``layers`` dim: prefill
stacks each layer's new cache along that dim, and decode writes each
layer's K/V into its view of the stacked cache in place.  The MoE layers'
auxiliary losses are summed once, at the end (a dense block adds no
launch for a zero loss, as XLA's fused zeros cost the reference none).
``remat`` comes with training.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.params import stack_tree, tree_map

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


def _require_ported(cfg: ModelConfig, kind: str) -> str:
    """The block's mixer; raises for one the port does not have yet."""
    mixer = _block_kind(cfg, kind)
    if mixer in ("ssm", "recurrent"):
        raise NotImplementedError(
            f"{cfg.name}: the {mixer!r} mixer is not ported yet (ROADMAP "
            f"queue 1 item 5a')")
    return mixer


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------


def block_meta(cfg: ModelConfig, kind: str, layer_idx: int) -> Dict[str, Any]:
    mixer = _require_ported(cfg, kind)
    m: Dict[str, Any] = {"norm1": L.norm_meta(cfg)}
    m["mixer"] = L.mla_meta(cfg) if mixer == "mla" else L.attn_meta(cfg)
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
    if _require_ported(cfg, kind) == "mla":
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
    mixer = _require_ported(cfg, kind)
    aux = None

    h = L.norm_apply(p["norm1"], cfg, x)
    if mixer == "mla":
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


def trunk_apply(
    params, cfg: ModelConfig, x: torch.Tensor, *,
    positions: torch.Tensor,
    causal: bool = True,
    caches: Optional[Dict[str, Any]] = None,
    index: Optional[torch.Tensor] = None,
    want_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], torch.Tensor]:
    """Run all segments.  Returns (x, new_caches|None, aux_loss).  Decode
    (``caches`` and ``index``) writes into ``caches``' tensors and returns
    them."""
    segs = build_segments(cfg)
    keep_cache = want_cache or index is not None
    new_caches: Dict[str, Any] = {}
    auxs: List[torch.Tensor] = []  # the MoE layers' losses, layer by layer

    def run(p_, x_, kind, c_, li):
        return block_apply(p_, cfg, x_, kind, positions=positions,
                           causal=causal, cache=c_, index=index,
                           want_cache=want_cache,
                           moe_layer=_is_moe_layer(cfg, li))

    for si, seg in enumerate(segs):
        seg_p = params[f"seg{si}"]
        seg_c = caches[f"seg{si}"] if caches is not None else None

        if not seg.scanned:
            entry_caches = {}
            for j, kind in enumerate(seg.kinds):
                cj = seg_c[f"p{j}"] if seg_c is not None else None
                x, entry_caches[f"p{j}"], aux = run(
                    seg_p[f"p{j}"], x, kind, cj, seg.layer_start + j)
                auxs += [aux] if aux is not None else []
            if keep_cache:
                new_caches[f"seg{si}"] = entry_caches
            continue

        # scanned segment: layer i is slice i of every stacked leaf --------
        per_layer: List[Dict[str, Any]] = []
        for i in range(seg.count):
            ncs = {}
            for j, kind in enumerate(seg.kinds):
                p_ij = tree_map(lambda t: t[i], seg_p[f"p{j}"])
                c_ij = (tree_map(lambda t: t[i], seg_c[f"p{j}"])
                        if seg_c is not None else None)
                x, ncs[f"p{j}"], aux = run(p_ij, x, kind, c_ij,
                                           seg.layer_start + j)
                auxs += [aux] if aux is not None else []
            per_layer.append(ncs)
        if seg_c is not None and index is not None:
            new_caches[f"seg{si}"] = seg_c  # written in place, slice by slice
        elif keep_cache:
            new_caches[f"seg{si}"] = tree_map(
                lambda *ts: torch.stack(ts), *per_layer)

    aux_total = (torch.stack(auxs).sum() if auxs
                 else torch.zeros((), dtype=f32, device=x.device))
    return x, (new_caches if keep_cache else None), aux_total
