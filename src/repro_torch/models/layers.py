"""Model building blocks of the port's zoo (port of
``repro/models/layers.py``).

Pure-function style: every block has a ``*_meta(cfg)`` builder returning a
:class:`repro_torch.models.params.ParamMeta` tree and an ``*_apply(params,
...)`` function.  Compute is ``cfg.dtype`` (bf16), accumulation f32; each
product casts its f32 master weight to the compute dtype first, as the
reference does.  Activations carry logical sharding constraints through
:func:`repro_torch.distributed.shard` (the identity without a mesh).

Ported here: norms, RoPE, activations, the GQA attention layer with its
prefill and decode paths (linear and ring caches), cross attention
against an encoder's memory (Whisper's decoder), multi-head latent
attention (DeepSeek V2/V3: materialised K/V in prefill, the absorbed form
against a latent cache in decode), the dense MLP, the MoE layer (the
sort-based dispatch, with the one-hot einsum dispatch kept as its
cross-check) and the embeddings.

No function here reads a value back to the host: decode positions,
cache slots, routing, capacity drops and expert counts stay on the
device, so a decode step can be captured as a CUDA graph.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig
from repro_torch.data.generators import torch_dtype
from repro_torch.distributed import shard, spmd
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
    if spmd.is_dtensor(k_cache):
        return _sharded_decode_attention(q, k_cache, v_cache, index=index,
                                         positions=positions, window=window,
                                         softcap=softcap)
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


def _sharded_decode_attention(q, k_cache, v_cache, *, index, positions,
                              window, softcap) -> torch.Tensor:
    """:func:`decode_attention` on a DTensor cache, split-K: the cache
    keeps its batch and position splits (its heads are gathered), the
    query is gathered to every head and split by batch as the cache is,
    and each rank scores its own positions.  The softmax's max and sum
    and the weighted values are reduced over the mesh dims that split
    the positions (all-reduces of one value a head, and of the output).
    A window masks the positions outside it; on a linear cache each rank
    reads only its part of the window's slice, as the plain path does."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = k_cache.device_mesh
    R = Replicate()
    kp = [p if p in (Shard(0), Shard(1)) else R for p in k_cache.placements]
    k_cache = k_cache.redistribute(mesh, kp)
    v_cache = v_cache.redistribute(mesh, kp)
    bp = [Shard(0) if p == Shard(0) else R for p in kp]  # batch split
    if not spmd.is_dtensor(q):
        q = DTensor.from_local(q, mesh, [R] * mesh.ndim, run_check=False)
    q = q.redistribute(mesh, bp)
    B, S, Hkv, D = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hkv
    coord = mesh.get_coordinate()
    rows, first = S, 0
    for i, p in enumerate(kp):
        if p == Shard(1):
            rows //= mesh.size(i)
            first += coord[i] * rows
    idx, positions = (t.full_tensor() if spmd.is_dtensor(t) else t
                      for t in (index, positions))
    kl, vl, ql = k_cache.to_local(), v_cache.to_local(), q.to_local()
    if positions is None and window is not None and window < S:
        # the window slice of a linear cache, as :func:`decode_attention`
        # reads it: each rank reads the ``min(window, rows)`` of its rows
        # that hold the slice's part on this rank
        w = min(window, rows)
        start = torch.clamp(idx - window + 1, 0, S - window)
        at = torch.clamp(start - first, 0, rows - w) + torch.arange(
            w, device=idx.device)
        kl, vl = kl.index_select(1, at), vl.index_select(1, at)
        pos = first + at
    elif positions is None:
        pos = first + torch.arange(rows, device=idx.device)
    else:
        pos = positions[first:first + rows]

    def reduced(t, op):
        pl = [Partial(op) if p == Shard(1) else b for p, b in zip(kp, bp)]
        return DTensor.from_local(t, mesh, pl, run_check=False
                                  ).redistribute(mesh, bp).to_local()

    qr = ql.reshape(ql.shape[0], Hkv, G, D).to(f32) / math.sqrt(D)
    s = _softcap(torch.einsum("bhgd,bkhd->bhgk", qr, kl.to(f32)), softcap)
    mask = (pos >= 0) & (pos <= idx)
    if window is not None:
        mask = mask & (pos > idx - window)
    s = s.masked_fill(~mask, -math.inf)
    top = reduced(s.amax(dim=-1, keepdim=True), "max")
    p = torch.exp(s - top)
    total = reduced(p.sum(dim=-1, keepdim=True), "sum")
    o = reduced(torch.einsum("bhgk,bkhd->bhgd", p, vl.to(f32)), "sum")
    out = (o / total).reshape(ql.shape[0], 1, Hq, D).to(q.dtype)
    return DTensor.from_local(out, mesh, bp, run_check=False,
                              shape=torch.Size((B, 1, Hq, D)),
                              stride=spmd.contiguous_strides((B, 1, Hq, D)))


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
        kc = spmd.index_copy_(cache["k"], 1, slot, k.to(dt))
        vc = spmd.index_copy_(cache["v"], 1, slot, v.to(dt))
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


def cross_attn_apply(p, cfg: ModelConfig, x: torch.Tensor, memory_kv):
    """Cross attention against precomputed encoder K/V (whisper decoder):
    non-causal, every memory position visible."""
    dt = torch_dtype(cfg.dtype)
    q = _project(x, p["wq"], dt)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
    k, v = memory_kv
    out = flash_attention(q, k, v, causal=False)
    H, K, d = p["wo"].shape
    out = out.flatten(-2) @ p["wo"].to(dt).reshape(H * K, d)
    return shard(out, "batch", "seq", "embed")


def cross_attn_kv(p, cfg: ModelConfig, memory: torch.Tensor):
    """The encoder memory's K and V (B, S_enc, Hkv, D) for
    :func:`cross_attn_apply`."""
    dt = torch_dtype(cfg.dtype)
    k = _project(memory, p["wk"], dt)
    v = _project(memory, p["wv"], dt)
    if cfg.qk_norm:
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    return k, v


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek V2/V3)
# ---------------------------------------------------------------------------


def mla_meta(cfg: ModelConfig) -> Dict[str, Any]:
    m_: MLAConfig = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk = m_.nope_head_dim + m_.rope_head_dim
    pd = torch_dtype(cfg.param_dtype)
    out: Dict[str, Any] = {}
    if m_.q_lora_rank:
        out["wdq"] = meta((d, m_.q_lora_rank), ("embed", "q_lora"), dtype=pd, fan_in=d)
        out["q_norm"] = meta((m_.q_lora_rank,), ("q_lora",), init="ones", dtype=pd)
        out["wuq"] = meta((m_.q_lora_rank, H, qk), ("q_lora", "heads", "qk_dim"),
                          dtype=pd, fan_in=m_.q_lora_rank)
    else:
        out["wq"] = meta((d, H, qk), ("embed", "heads", "qk_dim"), dtype=pd, fan_in=d)
    out["wdkv"] = meta((d, m_.kv_lora_rank + m_.rope_head_dim),
                       ("embed", "kv_lora"), dtype=pd, fan_in=d)
    out["kv_norm"] = meta((m_.kv_lora_rank,), ("kv_lora",), init="ones", dtype=pd)
    out["wuk"] = meta((m_.kv_lora_rank, H, m_.nope_head_dim),
                      ("kv_lora", "heads", "head_dim"), dtype=pd, fan_in=m_.kv_lora_rank)
    out["wuv"] = meta((m_.kv_lora_rank, H, m_.v_head_dim),
                      ("kv_lora", "heads", "head_dim"), dtype=pd, fan_in=m_.kv_lora_rank)
    out["wo"] = meta((H, m_.v_head_dim, d), ("heads", "head_dim", "embed"),
                     dtype=pd, fan_in=H * m_.v_head_dim)
    return out


def _mla_q(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    m_: MLAConfig = cfg.mla
    dt = torch_dtype(cfg.dtype)
    if m_.q_lora_rank:
        cq = x @ p["wdq"].to(dt)
        cq = rms_head_norm(p["q_norm"], cq, cfg.norm_eps)
        q = _project(cq, p["wuq"], dt)
    else:
        q = _project(x, p["wq"], dt)
    q_nope = q[..., : m_.nope_head_dim]
    q_pe = rope(q[..., m_.nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_pe


def _mla_ckv(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    m_: MLAConfig = cfg.mla
    dt = torch_dtype(cfg.dtype)
    dkv = x @ p["wdkv"].to(dt)
    ckv = rms_head_norm(p["kv_norm"], dkv[..., : m_.kv_lora_rank], cfg.norm_eps)
    k_pe = rope(dkv[..., None, m_.kv_lora_rank:], positions, cfg.rope_theta)
    return ckv, k_pe[:, :, 0]  # (B,S,rank), (B,S,rope_dim)


def mla_apply(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    index: Optional[torch.Tensor] = None,
    want_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Train/prefill: materialised per-head K/V through the shared flash
    attention, v's head dim padded up to the qk dim and cropped after.
    Decode: absorbed latent attention; the cache stores only ``ckv`` and
    ``k_pe`` (576 values a token at DeepSeek's widths), and the new
    token's are written into ``cache``'s tensors in place at ``index``,
    a slot chosen on the device, as :func:`attn_apply` writes K/V."""
    m_: MLAConfig = cfg.mla
    dt = torch_dtype(cfg.dtype)
    q_nope, q_pe = _mla_q(p, cfg, x, positions)
    ckv, k_pe = _mla_ckv(p, cfg, x, positions)

    new_cache = None
    if cache is not None and index is not None:
        slot = index.reshape(1).to(torch.int64)
        ckv_c = spmd.index_copy_(cache["ckv"], 1, slot, ckv.to(dt))
        kpe_c = spmd.index_copy_(cache["k_pe"], 1, slot, k_pe.to(dt))
        ckv_c = shard(ckv_c, "batch", "kv_seq", None)
        kpe_c = shard(kpe_c, "batch", "kv_seq", None)
        new_cache = {"ckv": ckv_c, "k_pe": kpe_c}
        # absorbed: q_lat = q_nope @ W_uk  -> attend in latent space
        scale = 1.0 / math.sqrt(m_.nope_head_dim + m_.rope_head_dim)
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wuk"].to(dt))
        s = torch.einsum("bshr,btr->bhst", q_lat.to(f32), ckv_c.to(f32))
        s = s + torch.einsum("bshk,btk->bhst", q_pe.to(f32), kpe_c.to(f32))
        s = s * scale
        mask = torch.arange(ckv_c.shape[1], device=x.device) <= index
        s = s.masked_fill(~mask, -math.inf)
        pr = torch.softmax(s, dim=-1)
        ctx_lat = torch.einsum("bhst,btr->bshr", pr, ckv_c.to(f32)).to(dt)
        ctx = torch.einsum("bshr,rhk->bshk", ctx_lat, p["wuv"].to(dt))
    else:
        k_nope = _project(ckv, p["wuk"], dt)
        v = _project(ckv, p["wuv"], dt)
        k = torch.cat([k_nope, k_pe[:, :, None].expand(
            *k_nope.shape[:3], m_.rope_head_dim)], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        q = shard(q, "batch", "seq", "heads", None)
        k = shard(k, "batch", "seq", "heads", None)
        # pad v's head dim up to qk dim for the shared flash attention, then crop
        qk_dim = m_.nope_head_dim + m_.rope_head_dim
        def pad(t):
            return F.pad(t, (0, qk_dim - m_.v_head_dim))
        # on DTensors shard by shard: the head dim is whole on every rank
        vpad = spmd.local_op(pad, v) if spmd.is_dtensor(v) else pad(v)
        ctx = flash_attention(q, k, vpad, causal=True)[..., : m_.v_head_dim]
        if want_cache:
            new_cache = {
                "ckv": shard(ckv.to(dt), "batch", "kv_seq", None),
                "k_pe": shard(k_pe.to(dt), "batch", "kv_seq", None),
            }
    H, K, d = p["wo"].shape
    out = ctx.flatten(-2) @ p["wo"].to(dt).reshape(H * K, d)
    return shard(out, "batch", "seq", "embed"), new_cache


def mla_cache_meta(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, ParamMeta]:
    m_ = cfg.mla
    dt = torch_dtype(cfg.dtype)
    return {
        "ckv": meta((batch, seq, m_.kv_lora_rank), ("batch", "kv_seq", None),
                    init="zeros", dtype=dt),
        "k_pe": meta((batch, seq, m_.rope_head_dim), ("batch", "kv_seq", None),
                     init="zeros", dtype=dt),
    }


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
# MoE layer (sort-based dispatch; einsum dispatch kept as the cross-check)
# ---------------------------------------------------------------------------


def moe_meta(cfg: ModelConfig) -> Dict[str, Any]:
    mo: MoEConfig = cfg.moe
    d, ff, E = cfg.d_model, mo.d_ff, mo.num_experts
    pd = torch_dtype(cfg.param_dtype)
    m: Dict[str, Any] = {
        "router": meta((d, E), ("embed", "expert"), dtype=f32, fan_in=d),
        "wi": meta((E, d, ff), ("expert", "embed", "expert_mlp"), dtype=pd, fan_in=d),
        "wg": meta((E, d, ff), ("expert", "embed", "expert_mlp"), dtype=pd, fan_in=d),
        "wo": meta((E, ff, d), ("expert", "expert_mlp", "embed"), dtype=pd, fan_in=ff),
    }
    if mo.num_shared_experts:
        m["shared"] = mlp_meta(cfg, width=mo.d_ff * mo.num_shared_experts)
    return m


def _capacity(mo: MoEConfig, tokens: int) -> int:
    c = int(tokens * mo.experts_per_token * mo.capacity_factor / mo.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def _dispatch_groups(x: torch.Tensor, probs: torch.Tensor,
                     top_ids: torch.Tensor, mo: MoEConfig, capacity: int):
    """Sort-based dispatch of G token groups at once (the reference's
    ``vmap`` of :func:`moe_dispatch_sort`).

    x: (G, T, d); probs/top_ids: (G, T, k).  Returns (expert_in (G,E,C,d),
    slot (G,T*k), st (G,T*k), w (G,T*k), counts (G,E)), each group's as
    the reference computes it alone; indices and counts are int64.  The
    expert counts are a ``scatter_add_`` into zeros (``bincount`` would
    read its size back to the host) and the buffer fill an
    ``index_add_`` at each group's slots offset by ``g * (E*C + 1)``:
    kept slots are distinct, so only the drop slot ``E*C`` takes more than
    one (zero) row and the fill is deterministic on the card too."""
    G, T, d = x.shape
    E, k = mo.num_experts, mo.experts_per_token
    C = capacity
    dev = x.device
    n = T * k
    flat_e = top_ids.reshape(G, n).to(torch.int64)
    flat_w = probs.reshape(G, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    # assignment j is token j // k's
    se, sw, st = flat_e.gather(1, order), flat_w.gather(1, order), order // k
    counts = torch.zeros((G, E), dtype=torch.int64, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(n, device=dev) - starts.gather(1, se)
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)
    g_off = torch.arange(G, device=dev)[:, None]
    xs = x.reshape(G * T, d).index_select(0, (st + g_off * T).reshape(-1))
    xs = xs * keep.reshape(-1, 1).to(x.dtype)
    buf = torch.zeros((G * (E * C + 1), d), dtype=x.dtype, device=dev)
    buf.index_add_(0, (slot + g_off * (E * C + 1)).reshape(-1), xs)
    expert_in = buf.view(G, E * C + 1, d)[:, : E * C].reshape(G, E, C, d)
    w = sw * keep.to(sw.dtype)
    return expert_in, slot, st, w, counts


def _combine_groups(expert_out: torch.Tensor, slot: torch.Tensor,
                    st: torch.Tensor, w: torch.Tensor,
                    num_tokens: int) -> torch.Tensor:
    """Inverse of :func:`_dispatch_groups`: (G,E,C,d) expert outputs ->
    (G,T,d) token outputs.

    The reference scatter-adds each assignment's weighted row into its
    token (``.at[st].add``).  On the card that is an ``index_add_`` with
    atomics, whose bf16 sums change order from run to run.  Here each
    token's k rows are gathered in the order the scatter visits them (a
    stable argsort of ``st``: the token's assignments by ascending
    expert) and added one after another in the output dtype: the same
    function, deterministic on either device."""
    G, E, C, d = expert_out.shape
    n = st.shape[1]
    k = n // num_tokens
    dev = expert_out.device
    pad = torch.cat([expert_out.reshape(G, E * C, d),
                     torch.zeros((G, 1, d), dtype=expert_out.dtype,
                                 device=dev)], dim=1)
    perm = torch.argsort(st, dim=-1, stable=True)
    rows = slot.gather(1, perm) + torch.arange(G, device=dev)[:, None] * (
        E * C + 1)
    per_assign = pad.reshape(G * (E * C + 1), d).index_select(
        0, rows.reshape(-1)).view(G, num_tokens, k, d)
    per_assign = per_assign * w.gather(1, perm).to(expert_out.dtype).view(
        G, num_tokens, k, 1)
    out = per_assign[:, :, 0]
    for i in range(1, k):
        out = out + per_assign[:, :, i]
    return out


def moe_dispatch_sort(x_g, probs, top_ids, mo: MoEConfig, capacity: int):
    """Sort-based dispatch for one token group.

    x_g: (T, d); probs/top_ids: (T, k).  Returns
    (expert_in (E,C,d), slot (T*k,), st (T*k,), w (T*k,), counts (E,)) —
    slot/st/w feed :func:`moe_combine_sort`.
    """
    out = _dispatch_groups(x_g[None], probs[None], top_ids[None], mo, capacity)
    return tuple(t[0] for t in out)


def moe_combine_sort(expert_out, slot, st, w, num_tokens: int):
    """Inverse of dispatch: (E,C,d) expert outputs -> (T,d) token outputs."""
    return _combine_groups(expert_out[None], slot[None], st[None], w[None],
                           num_tokens)[0]


def _experts(cfg: ModelConfig, expert_in: torch.Tensor, wi, wg, wo,
             axes: Tuple) -> torch.Tensor:
    """The stacked gated experts on (..., E, C, d) inputs, weights in the
    compute dtype: ``ecd,edf->ecf`` twice, then ``ecf,efd->ecd``."""
    expert_in = shard(expert_in, *axes, "embed")
    if spmd.is_dtensor(expert_in):
        # each rank runs its own experts on its own groups
        def local(x, wi, wg, wo):
            return (activation(cfg, x @ wg) * (x @ wi)) @ wo
        return shard(spmd.local_experts(local, expert_in, wi, wg, wo),
                     *axes, "embed")
    h = expert_in @ wi
    g = expert_in @ wg
    h = shard(activation(cfg, g) * h, *axes, "expert_mlp")
    return shard(h @ wo, *axes, "embed")


def moe_apply(p, cfg: ModelConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss).  Groups tokens, dispatches with the
    sort-based scheme, runs the stacked experts.  ``scan_groups`` runs the
    groups one after another (one group's dispatch buffers live at a
    time), else all at once along a leading group dim; ``ep_major`` only
    names other sharding axes, the identity without a mesh.  A config
    whose ``B*S`` tokens exceed one group must fill whole groups, as the
    reference asserts."""
    mo: MoEConfig = cfg.moe
    dt = torch_dtype(cfg.dtype)
    B, S, d = x.shape
    T_all = B * S
    Tg = min(mo.group_size, T_all)
    G = T_all // Tg
    if G * Tg != T_all:
        raise ValueError(f"tokens {T_all} not divisible by group {Tg}")
    xg = shard(x.reshape(G, Tg, d), "batch", None, "embed")

    logits = xg.to(f32) @ p["router"].to(f32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = torch.topk(probs, mo.experts_per_token, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)

    C = _capacity(mo, Tg)
    wi, wg, wo = (p[n].to(dt) for n in ("wi", "wg", "wo"))

    if mo.scan_groups and G > 1:
        # sequential groups: one group's (E, C, d) buffers live at a time
        xg_rep = shard(xg, None, None, "embed")
        outs, counts = [], []
        for g in range(G):
            expert_in, slot, st, w, cnt = _dispatch_groups(
                xg_rep[g:g + 1], top_p[g:g + 1].to(dt), top_ids[g:g + 1],
                mo, C)
            y = _experts(cfg, expert_in, wi, wg, wo, (None, "expert", None))
            outs.append(_combine_groups(y, slot, st, w, Tg))
            counts.append(cnt)
        out, counts = torch.cat(outs), torch.cat(counts)
    elif spmd.is_dtensor(xg):
        # each rank dispatches and combines its own groups
        expert_in, slot, st, w, counts = spmd.group_local(
            lambda *a: _dispatch_groups(*a, mo, C), xg, top_p.to(dt),
            top_ids)
        axes = ((None if mo.ep_major else "batch"), "expert", None)
        y = _experts(cfg, expert_in, wi, wg, wo, axes)
        out = spmd.group_local(
            lambda *a: _combine_groups(*a, Tg), y, slot, st, w)
    else:
        expert_in, slot, st, w, counts = _dispatch_groups(
            xg, top_p.to(dt), top_ids, mo, C)
        # expert-major: only the dispatched tokens reshard, never weights
        axes = ((None if mo.ep_major else "batch"), "expert", None)
        y = _experts(cfg, expert_in, wi, wg, wo, axes)
        out = _combine_groups(y, slot, st, w, Tg)
    out = out.reshape(B, S, d)

    if mo.num_shared_experts:
        out = out + mlp_apply(p["shared"], cfg, x)

    # load-balance aux loss (Switch/GShard style)
    frac_tokens = counts.to(f32).sum(0) / (G * Tg * mo.experts_per_token)
    frac_probs = probs.mean(dim=(0, 1))
    aux = mo.num_experts * torch.sum(frac_tokens * frac_probs) * mo.aux_loss_weight
    return shard(out, "batch", "seq", "embed"), aux


def moe_apply_einsum(p, cfg: ModelConfig,
                     x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard-style one-hot einsum dispatch (reference / small-E path):
    one group of all ``B*S`` tokens, priority by choice rank, then token."""
    mo: MoEConfig = cfg.moe
    dt = torch_dtype(cfg.dtype)
    B, S, d = x.shape
    T = B * S
    dev = x.device
    xf = x.reshape(T, d)
    logits = xf.to(f32) @ p["router"].to(f32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = torch.topk(probs, mo.experts_per_token, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)
    C = _capacity(mo, T)
    E = mo.num_experts
    experts = torch.arange(E, device=dev)

    # sequential-priority positions over the k choices
    counts = torch.zeros(E, dtype=torch.int64, device=dev)
    ohs, poss, keeps = [], [], []
    for i in range(mo.experts_per_token):
        oh = (top_ids[:, i, None] == experts).to(torch.int64)      # (T, E)
        pos = counts[None, :] + torch.cumsum(oh, dim=0) - oh        # (T, E)
        counts = counts + oh.sum(0)
        pos_t = (pos * oh).sum(-1)                                  # (T,)
        ohs.append(oh)
        poss.append(pos_t)
        keeps.append((pos_t < C) & (oh.sum(-1) > 0))
    disp = torch.zeros((T, E, C), dtype=dt, device=dev)
    comb = torch.zeros((T, E, C), dtype=f32, device=dev)
    t_idx = torch.arange(T, device=dev)
    for i in range(mo.experts_per_token):
        at = (t_idx, top_ids[:, i], torch.clamp(poss[i], 0, C - 1))
        disp.index_put_(at, keeps[i].to(dt), accumulate=True)
        comb.index_put_(at, top_p[:, i] * keeps[i].to(f32), accumulate=True)
    expert_in = torch.einsum("tec,td->ecd", disp, xf)
    y = _experts(cfg, expert_in, p["wi"].to(dt), p["wg"].to(dt),
                 p["wo"].to(dt), ("expert", None))
    out = torch.einsum("tec,ecd->td", comb.to(dt), y).reshape(B, S, d)
    if mo.num_shared_experts:
        out = out + mlp_apply(p["shared"], cfg, x)
    frac_tokens = torch.zeros(E, dtype=f32, device=dev)
    for oh in ohs:
        frac_tokens = frac_tokens + oh.to(f32).sum(0)
    frac_tokens = frac_tokens / (T * mo.experts_per_token)
    aux = E * torch.sum(frac_tokens * probs.mean(0)) * mo.aux_loss_weight
    return out, aux


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
    the cast table, gathered before a narrowing cast (the same values, and
    no cast of the whole table), after a widening one (so the backward
    pass sums a row's gradients in the wider dtype, as the reference's
    scatter-add does)."""
    dt = torch_dtype(cfg.dtype)

    def rows(table, ids):
        wide = torch.promote_types(table.dtype, dt)
        if spmd.is_dtensor(table) and any(p.is_shard(0)
                                          for p in table.placements):
            return spmd.embedding(ids, table.to(wide)).to(dt)
        return F.embedding(ids, table.to(wide)).to(dt)

    x = rows(p["tokens"], tokens)
    if cfg.embedding_scale:
        # sqrt(d_model) rounded to the dtype, as the reference's factor is
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=dt,
                           device=x.device)
    if cfg.learned_pos_embed and positions is not None:
        x = x + rows(p["pos"], positions)
    return shard(x, "batch", "seq", "embed")


def unembed_apply(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = torch_dtype(cfg.dtype)
    if cfg.tie_embeddings:
        logits = x @ p["tokens"].to(dt).T
    else:
        logits = x @ p["head"].to(dt)
    logits = _softcap(logits.to(f32), cfg.final_softcap)
    return shard(logits, "batch", "seq", "vocab")
