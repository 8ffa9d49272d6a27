"""Chunked online-softmax attention, forward and backward (port of
``repro/models/flash.py``: ``fwd_impl``, ``bwd_impl`` and the custom VJP
that joins them).

Queries run in chunks of ``q_chunk`` rows, each against a band of
``kv_chunk``-row key blocks, with the softmax statistics (running max,
sum, accumulator) in f32.  Masks are additive f32 ``(qc, kc)`` biases of
``NEG_INF`` built from the block's positions, exactly as the reference
builds them, so a row whose block is wholly masked adds the same
transient terms that the next visible block's correction erases.  Scores
and the probability-value product take their operands in their own dtype
and accumulate in f32 (the reference's ``preferred_element_type=f32``):
the operands are widened to f32, which is exact, before the product.
With ``p_bf16`` the probability block is rounded to bf16, and it is
always cast to ``v``'s dtype before the value product, as in the
reference.  Sliding-window layers visit only the statically bounded band
of key blocks (work proportional to ``S * window``).  GQA runs by
grouping query heads: ``(B, S, Hkv, G, D)``.

This is plain PyTorch and no library attention: the zoo keeps its own
attention, as the reference's does.  The band and block loops are Python
loops over static block indices, so a call reads nothing back from the
device.

The backward pass (:func:`flash_backward`, the reference's ``bwd_impl``)
recomputes the scores block by block from the saved lse, so no (Sq, Skv)
tensor outlives a block: ``D = rowsum(dout * out)`` in f32, then for each
visible block ``dv += p^T dout``, ``dp = dout v^T``, ``ds = p (dp - D)``
(times softcap's ``1 - tanh^2``), ``dq += ds k`` and ``dk += ds^T q``
with ``ds`` cast to the key's dtype, the GQA group axis summed into
``dk``/``dv``, and ``dq``, ``dk`` scaled once at the end.
:func:`flash_attention` runs the forward and this backward through one
``torch.autograd.Function`` (the reference's ``custom_vjp``), which
saves ``(q, k, v, out, lse)`` and nothing else.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

f32 = torch.float32
NEG_INF = -1e30


def _band_params(Sq, Skv, qc, kc, window, causal):
    nq = -(-Sq // qc)
    nk = -(-Skv // kc)
    use_band = window is not None and causal
    nband = (-(-(window + qc) // kc) + 1) if use_band else nk
    nband = min(nband, nk)
    return nq, nk, use_band, nband


def _bias_2d(q_idx, k_idx, Skv, causal, window):
    """Additive f32 (qc, kc) mask bias: 0 where visible, NEG_INF elsewhere."""
    ok = k_idx[None, :] < Skv
    if causal:
        ok = ok & (k_idx[None, :] <= q_idx[:, None])
    if window is not None:
        ok = ok & (k_idx[None, :] > q_idx[:, None] - window)
    return torch.full(ok.shape, NEG_INF, dtype=f32,
                      device=ok.device).masked_fill_(ok, 0.0)


def _block_start(qi, qc, kc, nk, nband, use_band, window, q_offset) -> int:
    if not use_band:
        return 0
    lo = q_offset + qi * qc - (window + kc - 1)
    return min(max(lo // kc, 0), max(nk - nband, 0))


def _qk(qb, kb, scale, softcap):
    """(B,qc,Hkv,G,D) x (B,kc,Hkv,D) -> f32 scores (B,Hkv,G,qc,kc)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qb.to(f32), kb.to(f32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s


def _pad_seq(t: torch.Tensor, n: int) -> torch.Tensor:
    """Zero rows appended to dim 1 of a (B, S, H, D) tensor."""
    return F.pad(t, (0, 0, 0, 0, 0, n)) if n else t


def flash_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    p_bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: ``out`` (B, Sq, Hq, D) in ``q``'s dtype and the
    per-chunk log-sum-exp ``lse`` (nq, B, Hkv, G, qc) in f32, the residual
    the backward pass reads."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Skv)
    nq, nk, use_band, nband = _band_params(Sq, Skv, qc, kc, window, causal)
    qr = _pad_seq(q, nq * qc - Sq).reshape(B, nq, qc, Hkv, G, D)
    kr = _pad_seq(k, nk * kc - Skv).reshape(B, nk, kc, Hkv, D)
    vr = _pad_seq(v, nk * kc - Skv).reshape(B, nk, kc, Hkv, D)
    dev = q.device
    outs, lses = [], []
    for qi in range(nq):
        qb = qr[:, qi]                                         # (B,qc,Hkv,G,D)
        q_idx = q_offset + qi * qc + torch.arange(qc, device=dev)
        start = _block_start(qi, qc, kc, nk, nband, use_band, window,
                             q_offset)
        m = torch.full((B, Hkv, G, qc), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((B, Hkv, G, qc), dtype=f32, device=dev)
        acc = torch.zeros((B, Hkv, G, qc, D), dtype=f32, device=dev)
        for j in range(nband):
            kj = start + j
            kb, vb = kr[:, kj], vr[:, kj]
            k_idx = kj * kc + torch.arange(kc, device=dev)
            s = _qk(qb, kb, scale, softcap) + _bias_2d(
                q_idx, k_idx, Skv, causal, window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])                # 0 where masked
            if p_bf16:
                p = p.to(torch.bfloat16)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, dtype=f32)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vb.dtype).to(f32), vb.to(f32))
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
        outs.append(out.permute(0, 3, 1, 2, 4))                # (B,qc,Hkv,G,D)
    out = torch.stack(outs, dim=1).reshape(B, nq * qc, Hq, D)
    return out[:, :Sq].to(q.dtype), torch.stack(lses)


def flash_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    p_bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_forward`'s ``out`` for the
    cotangent ``dout``, from the forward's inputs, ``out`` and ``lse``,
    each in its input's dtype (the reference's ``bwd_impl``)."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Skv)
    nq, nk, use_band, nband = _band_params(Sq, Skv, qc, kc, window, causal)
    pq, pk = nq * qc - Sq, nk * kc - Skv
    qr = _pad_seq(q, pq).reshape(B, nq, qc, Hkv, G, D)
    dor = _pad_seq(dout, pq).reshape(B, nq, qc, Hkv, G, D)
    our = _pad_seq(out, pq).reshape(B, nq, qc, Hkv, G, D)
    kr = _pad_seq(k, pk).reshape(B, nk, kc, Hkv, D)
    vr = _pad_seq(v, pk).reshape(B, nk, kc, Hkv, D)
    # D_i = rowsum(dout * out), f32: (B, nq, qc, Hkv, G)
    Dr = (dor.to(f32) * our.to(f32)).sum(dim=-1)
    dev = q.device
    dk_all = torch.zeros((B, nk, kc, Hkv, D), dtype=f32, device=dev)
    dv_all = torch.zeros((B, nk, kc, Hkv, D), dtype=f32, device=dev)
    dqs = []
    for qi in range(nq):
        qb = qr[:, qi].to(f32)                                 # (B,qc,Hkv,G,D)
        dob = dor[:, qi].to(f32)
        Db = Dr[:, qi].permute(0, 2, 3, 1)                     # (B,Hkv,G,qc)
        lse_b = lse[qi]                                        # (B,Hkv,G,qc)
        q_idx = q_offset + qi * qc + torch.arange(qc, device=dev)
        start = _block_start(qi, qc, kc, nk, nband, use_band, window,
                             q_offset)
        dq_acc = torch.zeros((B, qc, Hkv, G, D), dtype=f32, device=dev)
        for j in range(nband):
            kj = start + j
            kb, vb = kr[:, kj], vr[:, kj]
            k_idx = kj * kc + torch.arange(kc, device=dev)
            s_raw = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb.to(f32)) * scale
            s = (softcap * torch.tanh(s_raw / softcap) if softcap is not None
                 else s_raw)
            s = s + _bias_2d(q_idx, k_idx, Skv, causal, window)
            p = torch.exp(s - lse_b[..., None])                # (B,h,g,qc,kc)
            if p_bf16:
                p = p.to(torch.bfloat16)
            pc = p.to(vb.dtype).to(f32)
            dv_all[:, kj] += torch.einsum("bhgqk,bqhgd->bkhd", pc, dob)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", dob, vb.to(f32))
            ds = p.to(f32) * (dp - Db[..., None])
            if softcap is not None:
                ds = ds * (1.0 - torch.square(torch.tanh(s_raw / softcap)))
            dsc = ds.to(kb.dtype).to(f32)
            dq_acc += torch.einsum("bhgqk,bkhd->bqhgd", dsc, kb.to(f32))
            dk_all[:, kj] += torch.einsum("bhgqk,bqhgd->bkhd", dsc, qb)
        dqs.append(dq_acc * scale)
    dq = torch.stack(dqs, dim=1).reshape(B, nq * qc, Hq, D)
    dk = (dk_all * scale).reshape(B, nk * kc, Hkv, D)[:, :Skv]
    dv = dv_all.reshape(B, nk * kc, Hkv, D)[:, :Skv]
    return dq[:, :Sq].to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """:func:`flash_forward` with :func:`flash_backward` as its gradient;
    saves ``(q, k, v, out, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, opts):
        out, lse = flash_forward(q, k, v, **opts)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_backward(q, k, v, out, lse, dout, **ctx.opts), None)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    p_bf16: bool = False,
) -> torch.Tensor:
    """Attention of ``q`` (B, Sq, Hq, D) over ``k``, ``v`` (B, Skv, Hkv,
    D), differentiable through :func:`flash_backward` (the reference's
    ``flash_attention`` with its custom VJP)."""
    return _FlashAttention.apply(q, k, v, dict(
        causal=causal, window=window, softcap=softcap, q_offset=q_offset,
        q_chunk=q_chunk, kv_chunk=kv_chunk, p_bf16=p_bf16))
