"""Whisper-style encoder-decoder backbone (port of
``repro/models/whisper.py``).  [arXiv:2212.04356]

The conv frontend is a stub, as in the reference: the inputs carry
precomputed frame embeddings (B, S_enc, d_model), already 2x
time-downsampled (``cfg.encoder_downsample``).  Everything downstream —
encoder stack, decoder with cross attention, KV caches — is real.

Where the reference runs a stack with ``lax.scan``, the port runs a
Python loop over the stacked ``layers`` dim, as the trunk does: each
param leaf is ``unbind``-ed once a stack (``trunk.unstack``), and
``remat`` recomputes each layer in the backward pass, where the
reference wraps the scan's body in ``jax.checkpoint``.  Decode writes
the new token's self-attention K/V into its view of the stacked cache in
place and returns the caches it was given; the cross K/V, computed once
by the prefill, are read as they are.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.generators import torch_dtype
from repro_torch.distributed import shard
from repro_torch.models import layers as L
from repro_torch.models.params import meta, stack_tree, tree_map
from repro_torch.models.trunk import maybe_remat, unstack


# ---------------------------------------------------------------------------
# Meta
# ---------------------------------------------------------------------------


def enc_block_meta(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "norm1": L.norm_meta(cfg),
        "attn": L.attn_meta(cfg),
        "norm2": L.norm_meta(cfg),
        "ffn": L.mlp_meta(cfg),
    }


def dec_block_meta(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "norm1": L.norm_meta(cfg),
        "self_attn": L.attn_meta(cfg),
        "norm2": L.norm_meta(cfg),
        "cross_attn": L.attn_meta(cfg),
        "norm3": L.norm_meta(cfg),
        "ffn": L.mlp_meta(cfg),
    }


def whisper_meta(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "embed": L.embed_meta(cfg),
        "enc_pos": meta((cfg.max_position_embeddings, cfg.d_model),
                        ("pos", "embed"), init="embed",
                        dtype=torch_dtype(cfg.param_dtype)),
        "encoder": stack_tree(enc_block_meta(cfg), cfg.encoder_layers),
        "enc_norm": L.norm_meta(cfg),
        "decoder": stack_tree(dec_block_meta(cfg), cfg.num_layers),
        "dec_norm": L.norm_meta(cfg),
    }


def whisper_cache_meta(cfg: ModelConfig, batch: int,
                       seq: int) -> Dict[str, Any]:
    enc_len = max(seq // cfg.encoder_downsample, 1)
    kv = meta((batch, enc_len, cfg.num_kv_heads, cfg.resolved_head_dim()),
              ("batch", "kv_seq", "kv_heads", None), init="zeros",
              dtype=torch_dtype(cfg.dtype))
    cross = {"k": kv, "v": kv}
    return {
        "self": stack_tree(L.attn_cache_meta(cfg, batch, seq), cfg.num_layers),
        "cross": stack_tree(cross, cfg.num_layers),
    }


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _layer(tree, i: int):
    """Layer ``i`` of a stacked cache tree: views of slice ``i`` of each
    leaf (decode writes into them)."""
    return tree_map(lambda t: t[i], tree)


def encode(params, cfg: ModelConfig, frames: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """frames: (B, S_enc, d) stub embeddings -> encoder memory."""
    dt = torch_dtype(cfg.dtype)
    S = frames.shape[1]
    x = frames.to(dt) + params["enc_pos"][:S].to(dt)[None]
    x = shard(x, "batch", "seq", "embed")
    positions = torch.arange(S, device=frames.device)[None]

    def body(p, x):
        h = L.norm_apply(p["norm1"], cfg, x)
        a, _ = L.attn_apply(p["attn"], cfg, h, positions=positions,
                            causal=False)
        x = x + a
        h = L.norm_apply(p["norm2"], cfg, x)
        return x + L.mlp_apply(p["ffn"], cfg, h)

    body = maybe_remat(body, remat)
    for p in unstack(params["encoder"]):
        x = body(p, x)
    return L.norm_apply(params["enc_norm"], cfg, x)


def decode_stack(
    params, cfg: ModelConfig, tokens: torch.Tensor, *,
    memory: Optional[torch.Tensor] = None,
    caches: Optional[Dict[str, Any]] = None,
    index: Optional[torch.Tensor] = None,
    want_cache: bool = False,
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Decoder pass.  Train/prefill: ``memory`` given (the prefill, with
    ``want_cache``, returns new caches).  Decode: ``caches`` and ``index``
    given (a 0-d tensor); the new token's K/V are written into
    ``caches``, which are returned.  ``remat`` recomputes each layer in
    the backward pass."""
    dt = torch_dtype(cfg.dtype)
    B, S = tokens.shape
    pos_ids = torch.arange(S, device=tokens.device)[None] + (
        0 if index is None else index)
    x = L.embed_apply(params["embed"], cfg, tokens, positions=pos_ids)
    decoding = caches is not None and index is not None
    keep = want_cache or index is not None

    def body(p, x, c):
        h = L.norm_apply(p["norm1"], cfg, x)
        a, self_c = L.attn_apply(
            p["self_attn"], cfg, h, positions=pos_ids, causal=True,
            cache=(c["self"] if c is not None else None),
            index=index, want_cache=want_cache)
        x = x + a
        h = L.norm_apply(p["norm2"], cfg, x)
        if decoding:
            mem_kv = (c["cross"]["k"], c["cross"]["v"])
            cross_c = c["cross"]
        else:
            mem_kv = L.cross_attn_kv(p["cross_attn"], cfg, memory)
            cross_c = {"k": mem_kv[0].to(dt), "v": mem_kv[1].to(dt)}
        x = x + L.cross_attn_apply(p["cross_attn"], cfg, h, mem_kv)
        h = L.norm_apply(p["norm3"], cfg, x)
        x = x + L.mlp_apply(p["ffn"], cfg, h)
        return x, {"self": self_c, "cross": cross_c}

    body = maybe_remat(body, remat)
    per_layer: List[Dict[str, Any]] = []
    for i, p in enumerate(unstack(params["decoder"])):
        x, c = body(p, x, _layer(caches, i) if caches is not None else None)
        per_layer.append(c)

    x = L.norm_apply(params["dec_norm"], cfg, x)
    if not keep:
        return x, None
    if decoding:
        return x, caches  # written in place, slice by slice
    return x, tree_map(lambda *ts: torch.stack(ts), *per_layer)
