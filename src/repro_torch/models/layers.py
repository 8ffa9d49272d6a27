"""Model building blocks of the port's zoo (port of the dense parts of
``repro/models/layers.py``).

Pure-function style: every block has a ``*_meta(cfg)`` builder returning a
:class:`repro_torch.models.params.ParamMeta` tree and an ``*_apply(params,
...)`` function.  Compute is ``cfg.dtype`` (bf16), accumulation f32; each
product casts its f32 master weight to the compute dtype first, as the
reference does.  Activations carry logical sharding constraints through
:func:`repro_torch.distributed.shard` (the identity without a mesh).

Ported here: norms, RoPE, activations, the GQA attention layer with its
prefill and decode paths (linear and ring caches), the dense MLP and the
embeddings.  MLA, MoE and cross attention are not ported yet (ROADMAP
queue 1 item 5a'); :func:`repro_torch.models.model_zoo.build_model`
refuses the configs that need them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.data.generators import torch_dtype
from repro_torch.distributed import shard
from repro_torch.models.flash import flash_attention
from repro_torch.models.params import ParamMeta, meta

f32 = torch.float32

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_meta(cfg: ModelConfig, width: Optional[int] = None) -> Dict[str, ParamMeta]:
    d = width or cfg.d_model
    m = {"scale": meta((d,), ("embed",), init="ones")}
    if cfg.norm == "layernorm":
        m["bias"] = meta((d,), ("embed",), init="zeros")
    return m


def norm_apply(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if cfg.norm_mixed and dt != f32:
        # statistics in f32, normalisation applied in the input dtype
        xf = x.to(f32)
        if cfg.norm == "layernorm":
            mu = xf.mean(dim=-1, keepdim=True)
            var = (xf - mu).square().mean(dim=-1, keepdim=True)
            inv = torch.rsqrt(var + cfg.norm_eps)
            y = (x - mu.to(dt)) * inv.to(dt)
            return y * p["scale"].to(dt) + p["bias"].to(dt)
        ms = xf.square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(ms + cfg.norm_eps)
        return x * inv.to(dt) * p["scale"].to(dt)
    x = x.to(f32)
    if cfg.norm == "layernorm":
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].to(f32) + p["bias"].to(f32)
    else:
        ms = x.square().mean(dim=-1, keepdim=True)
        y = x * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].to(f32)
    return y.to(dt)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """qk-norm: rmsnorm over the head_dim axis."""
    dt = x.dtype
    x = x.to(f32)
    ms = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(ms + eps) * scale.to(f32)).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.exp(-math.log(theta)
                     * torch.arange(half, dtype=f32, device=x.device) / half)
    ang = positions[..., None].to(f32) * freq  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(f32), x[..., half:].to(f32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def activation(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    a = cfg.act
    if a in ("silu",):
        return F.silu(x)
    if a in ("gelu", "gelu_glu"):
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown act {a}")


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Attention.  Prefill runs repro_torch.models.flash; the function below is
# the straightforward online-softmax version kept as the shared oracle.
# ---------------------------------------------------------------------------


def flash_attention_reference(
    q: torch.Tensor,                   # (B, Sq, Hq, D)
    k: torch.Tensor,                   # (B, Skv, Hkv, D)
    v: torch.Tensor,                   # (B, Skv, Hkv, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    banded: bool = True,
) -> torch.Tensor:
    """Chunked online-softmax attention in f32 with ``-inf`` masks.

    ``banded=True`` + ``window`` restricts each q chunk to the statically
    bounded KV band it can see.
    """
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    dev = q.device

    qc = min(q_chunk, Sq)
    kc = min(kv_chunk, Skv)
    nq = -(-Sq // qc)
    nk = -(-Skv // kc)
    pq, pk = nq * qc - Sq, nk * kc - Skv
    qr = F.pad(q, (0, 0, 0, 0, 0, pq)).reshape(B, nq, qc, Hkv, G, D)
    kr = F.pad(k, (0, 0, 0, 0, 0, pk)).reshape(B, nk, kc, Hkv, D)
    vr = F.pad(v, (0, 0, 0, 0, 0, pk)).reshape(B, nk, kc, Hkv, D)

    use_band = banded and window is not None and causal
    nband = -(-(window + qc) // kc) + 1 if use_band else nk

    outs = []
    for qi in range(nq):
        qb = qr[:, qi].to(f32) * scale               # (B, qc, Hkv, G, D)
        q_idx = q_offset + qi * qc + torch.arange(qc, device=dev)
        start = 0
        if use_band:
            # kv chunks [start, start+nband) cover (q_hi - window, q_hi]
            lo = q_offset + qi * qc - (window + kc - 1)
            start = min(max(lo // kc, 0), max(nk - nband, 0))
        m = torch.full((B, Hkv, G, qc), -math.inf, dtype=f32, device=dev)
        l = torch.zeros((B, Hkv, G, qc), dtype=f32, device=dev)
        acc = torch.zeros((B, Hkv, G, qc, D), dtype=f32, device=dev)
        for j in range(nband):
            kj = start + j
            if kj >= nk:  # a band past the last key block: wholly masked
                continue
            kb, vb = kr[:, kj], vr[:, kj]
            k_idx = kj * kc + torch.arange(kc, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb.to(f32))
            s = _softcap(s, softcap)
            mask = k_idx[None, :] < Skv
            if causal:
                mask = mask & (k_idx[None, :] <= q_idx[:, None])
            if window is not None:
                mask = mask & (k_idx[None, :] > q_idx[:, None] - window)
            s = s.masked_fill(~mask, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked rows
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p = torch.exp(s - m_safe[..., None]).masked_fill(~mask, 0.0)
            corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vb.to(f32))
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))      # (B, qc, Hkv, G, D)
    out = torch.stack(outs, dim=1).reshape(B, nq * qc, Hq, D)
    return out[:, :Sq].to(q.dtype)


def decode_attention(
    q: torch.Tensor,                   # (B, 1, Hq, D)
    k_cache: torch.Tensor,             # (B, S, Hkv, D)
    v_cache: torch.Tensor,
    *,
    index: torch.Tensor,               # 0-d: position of the new token
    positions: Optional[torch.Tensor] = None,  # (S,) absolute cache positions
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention against a cache.

    For sliding-window layers on a *linear* cache, only a ``window``-sized
    slice is read, gathered at device-side positions (no host read).  Ring
    caches pass explicit ``positions`` instead.
    """
    B, S, Hkv, D = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)

    if positions is None and window is not None and window < S:
        start = torch.clamp(index - window + 1, 0, S - window)
        pos = start + torch.arange(window, device=k_cache.device)
        k_cache = k_cache.index_select(1, pos)
        v_cache = v_cache.index_select(1, pos)
    elif positions is None:
        pos = torch.arange(S, device=k_cache.device)
    else:
        pos = positions

    qr = q.reshape(B, Hkv, G, D).to(f32) * scale
    s = torch.einsum("bhgd,bkhd->bhgk", qr, k_cache.to(f32))
    s = _softcap(s, softcap)
    mask = (pos >= 0) & (pos <= index)
    if window is not None:
        mask = mask & (pos > index - window)
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.to(f32))
    return out.reshape(B, 1, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------


def attn_meta(cfg: ModelConfig) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    pd = torch_dtype(cfg.param_dtype)
    m: Dict[str, Any] = {
        "wq": meta((d, cfg.num_heads, hd), ("embed", "heads", "head_dim"),
                   dtype=pd, fan_in=d),
        "wk": meta((d, cfg.num_kv_heads, hd), ("embed", "kv_heads", "head_dim"),
                   dtype=pd, fan_in=d),
        "wv": meta((d, cfg.num_kv_heads, hd), ("embed", "kv_heads", "head_dim"),
                   dtype=pd, fan_in=d),
        "wo": meta((cfg.num_heads, hd, d), ("heads", "head_dim", "embed"),
                   dtype=pd, fan_in=cfg.num_heads * hd),
    }
    if cfg.qk_norm:
        m["q_norm"] = meta((hd,), ("head_dim",), init="ones", dtype=pd)
        m["k_norm"] = meta((hd,), ("head_dim",), init="ones", dtype=pd)
    return m


def _project(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``bsd,dhk->bshk``: x (B, S, d) times w (d, H, K) cast to ``dt``."""
    d, H, K = w.shape
    return (x @ w.to(dt).reshape(d, H * K)).unflatten(-1, (H, K))


def _qkv(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    dt = torch_dtype(cfg.dtype)
    q = _project(x, p["wq"], dt)
    k = _project(x, p["wk"], dt)
    v = _project(x, p["wv"], dt)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,                    # (B, S, d)
    *,
    layer_kind: str = "global",         # global | local
    positions: torch.Tensor,
    causal: bool = True,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    index: Optional[torch.Tensor] = None,  # decode position, 0-d
    want_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Attention of ``x``.  Decode (``cache`` and ``index`` given) writes
    the new token's K/V into ``cache``'s tensors in place, at the slot
    ``index`` (``index % window`` in a ring cache) chosen on the device,
    and returns them; the reference donates the caches instead."""
    dt = torch_dtype(cfg.dtype)
    window = cfg.sliding_window if layer_kind == "local" else None
    q, k, v = _qkv(p, cfg, x, positions)
    q = shard(q, "batch", "seq", "heads", None)

    new_cache = None
    if cache is not None and index is not None:
        # ---- decode: write k/v into the cache, attend against it --------
        S_c = cache["k"].shape[1]
        ring = window is not None and S_c == window
        slot = torch.remainder(index, window) if ring else index
        slot = slot.reshape(1).to(torch.int64)
        kc = cache["k"].index_copy_(1, slot, k.to(dt))
        vc = cache["v"].index_copy_(1, slot, v.to(dt))
        kc = shard(kc, "batch", "kv_seq", "kv_heads", None)
        vc = shard(vc, "batch", "kv_seq", "kv_heads", None)
        new_cache = {"k": kc, "v": vc}
        ring_pos = None
        if ring:
            j = torch.arange(S_c, device=x.device)
            ring_pos = index - torch.remainder(index - j, window)
        out = decode_attention(q, kc, vc, index=index, positions=ring_pos,
                               window=window, softcap=cfg.attn_softcap)
    else:
        # ---- train / prefill --------------------------------------------
        k = shard(k, "batch", "seq", "kv_heads", None)
        v = shard(v, "batch", "seq", "kv_heads", None)
        out = flash_attention(q, k, v, causal=causal, window=window,
                              p_bf16=cfg.attn_p_bf16,
                              q_chunk=cfg.attn_q_chunk,
                              kv_chunk=cfg.attn_kv_chunk,
                              softcap=cfg.attn_softcap)
        if want_cache:
            kq, vq = k.to(dt), v.to(dt)
            S = kq.shape[1]
            if window is not None and window < S:
                # ring layout: token at absolute position p sits at p % W
                kq = torch.roll(kq[:, -window:], S % window, dims=1)
                vq = torch.roll(vq[:, -window:], S % window, dims=1)
            new_cache = {
                "k": shard(kq, "batch", "kv_seq", "kv_heads", None),
                "v": shard(vq, "batch", "kv_seq", "kv_heads", None),
            }
    H, K, d = p["wo"].shape
    out = out.flatten(-2) @ p["wo"].to(dt).reshape(H * K, d)
    return shard(out, "batch", "seq", "embed"), new_cache


def attn_cache_meta(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, ParamMeta]:
    hd = cfg.resolved_head_dim()
    dt = torch_dtype(cfg.dtype)
    sh = (batch, seq, cfg.num_kv_heads, hd)
    ax = ("batch", "kv_seq", "kv_heads", None)
    return {"k": meta(sh, ax, init="zeros", dtype=dt),
            "v": meta(sh, ax, init="zeros", dtype=dt)}


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------


def mlp_meta(cfg: ModelConfig, width: Optional[int] = None) -> Dict[str, Any]:
    d = cfg.d_model
    ff = width or cfg.d_ff
    pd = torch_dtype(cfg.param_dtype)
    gated = cfg.act in ("silu", "gelu_glu")
    m = {
        "wi": meta((d, ff), ("embed", "mlp"), dtype=pd, fan_in=d),
        "wo": meta((ff, d), ("mlp", "embed"), dtype=pd, fan_in=ff),
    }
    if gated:
        m["wg"] = meta((d, ff), ("embed", "mlp"), dtype=pd, fan_in=d)
    return m


def mlp_apply(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = torch_dtype(cfg.dtype)
    h = x @ p["wi"].to(dt)
    if "wg" in p:
        g = x @ p["wg"].to(dt)
        h = activation(cfg, g) * h
    else:
        h = activation(cfg, h)
    h = shard(h, "batch", "seq", "mlp")
    out = h @ p["wo"].to(dt)
    return shard(out, "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Embeddings / unembedding
# ---------------------------------------------------------------------------


def embed_meta(cfg: ModelConfig) -> Dict[str, Any]:
    pd = torch_dtype(cfg.param_dtype)
    m = {"tokens": meta((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                        init="embed", dtype=pd)}
    if not cfg.tie_embeddings:
        m["head"] = meta((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                         dtype=pd, fan_in=cfg.d_model)
    if cfg.learned_pos_embed:
        m["pos"] = meta((cfg.max_position_embeddings, cfg.d_model),
                        ("pos", "embed"), init="embed", dtype=pd)
    return m


def embed_apply(p, cfg: ModelConfig, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows of the table for ``tokens``, in the compute dtype: the rows of
    the cast table, gathered before the cast (the same values)."""
    dt = torch_dtype(cfg.dtype)
    x = F.embedding(tokens, p["tokens"]).to(dt)
    if cfg.embedding_scale:
        # sqrt(d_model) rounded to the dtype, as the reference's factor is
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=dt,
                           device=x.device)
    if cfg.learned_pos_embed and positions is not None:
        x = x + F.embedding(positions, p["pos"]).to(dt)
    return shard(x, "batch", "seq", "embed")


def unembed_apply(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = torch_dtype(cfg.dtype)
    if cfg.tie_embeddings:
        logits = x @ p["tokens"].to(dt).T
    else:
        logits = x @ p["head"].to(dt)
    logits = _softcap(logits.to(f32), cfg.final_softcap)
    return shard(logits, "batch", "seq", "vocab")
