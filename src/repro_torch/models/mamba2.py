"""Mamba-2 SSD (state-space duality) block (port of
``repro/models/mamba2.py``).  [arXiv:2405.21060]

Chunked SSD algorithm: a within-chunk quadratic, attention-like term plus
an inter-chunk linear recurrence.  The reference carries the recurrence
with ``lax.scan`` over chunks; the port runs a Python loop over them.
Decode is a single recurrent state update, O(1) a token.

Decode writes the new conv tail and state into the cache tensors it is
given (``copy_``) and returns them, as the trunk's decode does for K/V;
it reads nothing back to the host.

The prefill caches the conv's *input*, the last ``conv_width - 1`` rows
of the projection before :func:`causal_conv1d`, which is what decode
convolves with the next token's projection.  The reference caches the
conv's output there (ROADMAP queue 3 item 18), so its decode after its
own prefill differs from its forward; every other output is the
reference's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.data.generators import torch_dtype
from repro_torch.distributed import shard
from repro_torch.models.params import meta

f32 = torch.float32


def _dims(cfg: ModelConfig):
    s: SSMConfig = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.state_dim
    return s, d_in, nheads, conv_dim


def ssd_block_meta(cfg: ModelConfig) -> Dict[str, Any]:
    s, d_in, H, conv_dim = _dims(cfg)
    d = cfg.d_model
    pd = torch_dtype(cfg.param_dtype)
    # in_proj packs [z, xBC, dt]
    proj_out = d_in + conv_dim + H
    return {
        "win": meta((d, proj_out), ("embed", "ssm_inner"), dtype=pd, fan_in=d),
        "conv_w": meta((s.conv_width, conv_dim), ("conv", "ssm_inner"),
                       dtype=pd, init="scaled", fan_in=s.conv_width),
        "conv_b": meta((conv_dim,), ("ssm_inner",), init="zeros", dtype=pd),
        "a_log": meta((H,), ("ssm_heads",), init="ones", dtype=f32),
        "d_skip": meta((H,), ("ssm_heads",), init="ones", dtype=f32),
        "dt_bias": meta((H,), ("ssm_heads",), init="zeros", dtype=f32),
        "norm_scale": meta((d_in,), ("ssm_inner",), init="ones", dtype=pd),
        "wout": meta((d_in, d), ("ssm_inner", "embed"), dtype=pd, fan_in=d_in),
    }


def ssd_cache_meta(cfg: ModelConfig, batch: int) -> Dict[str, Any]:
    s, d_in, H, conv_dim = _dims(cfg)
    return {
        "conv": meta((batch, s.conv_width - 1, conv_dim),
                     ("batch", None, "ssm_inner"), init="zeros",
                     dtype=torch_dtype(cfg.dtype)),
        "state": meta((batch, H, s.head_dim, s.state_dim),
                      ("batch", "ssm_heads", None, "ssm_state"),
                      init="zeros", dtype=f32),
    }


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv via shifted adds (width is tiny), then SiLU.

    x: (B, S, C); w: (W, C); tail: (B, W-1, C) past context or None.
    """
    W = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    S = x.shape[1]
    acc = torch.zeros(x.shape, dtype=f32, device=x.device) + b.to(f32)
    for i in range(W):
        acc = acc + xp[:, i:i + S].to(f32) * w[i].to(f32)
    return F.silu(acc).to(x.dtype)


def conv_tail(x: torch.Tensor, width: int) -> torch.Tensor:
    """The last ``width - 1`` rows of ``x`` (B, S, C), left-padded with
    zeros when S is shorter: the context decode's conv needs.  A copy,
    so the cache does not keep ``x`` alive."""
    tail = x[:, -(width - 1):]
    pad = width - 1 - tail.shape[1]
    if pad > 0:
        return F.pad(tail, (0, 0, pad, 0))
    return tail.clone(memory_format=torch.contiguous_format)


def ssd_chunked(x, dt, a_log, Bm, Cm, d_skip, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Chunked SSD scan.

    x: (B,S,H,P)  dt: (B,S,H)  a_log: (H,)  Bm,Cm: (B,S,G,N)  d_skip: (H,)
    Returns y (B,S,H,P) f32 and optionally the final state (B,H,P,N).
    Padded positions have ``dt = 0``, so they neither decay nor add to the
    state.
    """
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    Nc = (S + pad) // L
    rep = H // G
    A = -torch.exp(a_log.to(f32))                         # (H,) negative

    def to_chunks(t):
        return t.reshape((B, Nc, L) + tuple(t.shape[2:]))

    xc, dtc = to_chunks(x.to(f32)), to_chunks(dt.to(f32))
    # (B, Nc, L, H, N): each group's B and C repeated over its heads
    Bc = torch.repeat_interleave(to_chunks(Bm.to(f32)), rep, dim=3)
    Cc = torch.repeat_interleave(to_chunks(Cm.to(f32)), rep, dim=3)

    dA = dtc * A                                          # (B,Nc,L,H) <= 0
    cum = torch.cumsum(dA, dim=2)                         # within-chunk cumsum

    state = (torch.zeros((B, H, P, N), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))

    idx = torch.arange(L, device=x.device)
    ltri = idx[:, None] >= idx[None, :]                   # (L, L)

    ys = []
    for c in range(Nc):
        xcb, dtb, Bb, Cb, cumb = (xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c],
                                  cum[:, c])              # (B,L,...)
        dtx = xcb * dtb[..., None]                        # (B,L,H,P)
        # intra-chunk (quadratic within L); mask the exponent BEFORE exp so
        # the (anti-causal) upper triangle cannot overflow to inf.
        diff = (cumb[:, :, None] - cumb[:, None, :]).permute(0, 3, 1, 2)
        decay = torch.exp(diff.masked_fill(~ltri, -torch.inf))
        scores = torch.einsum("blhn,bshn->bhls", Cb, Bb)
        att = scores * decay
        y_diag = torch.einsum("bhls,bshp->blhp", att, dtx)
        # inter-chunk
        y_off = torch.einsum("blhn,bhpn->blhp",
                             Cb * torch.exp(cumb)[..., None], state)
        # state update
        decay_to_end = torch.exp(cumb[:, -1:, :] - cumb)  # (B,L,H)
        s_chunk = torch.einsum("blhn,blhp->bhpn",
                               Bb * (dtb * decay_to_end)[..., None], xcb)
        chunk_decay = torch.exp(cumb[:, -1])              # (B,H)
        state = state * chunk_decay[..., None, None] + s_chunk
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(B, S + pad, H, P)[:, :S]
    y = y + x.to(f32)[:, :S] * d_skip.to(f32)[None, None, :, None]
    if return_state:
        return y, state
    return y


def ssd_block_apply(
    p, cfg: ModelConfig, x: torch.Tensor, *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    index: Optional[torch.Tensor] = None,
    want_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The block's output (B, S, d).  Decode (``cache`` and ``index``)
    writes the new conv tail and state into ``cache``'s tensors and
    returns them; a prefill with ``want_cache`` returns new ones."""
    s, d_in, H, conv_dim = _dims(cfg)
    dt_ = torch_dtype(cfg.dtype)
    B = x.shape[0]
    proj = x @ p["win"].to(dt_)
    z, xBC, dt_raw = torch.split(proj, [d_in, conv_dim, H], dim=-1)
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"].to(f32))
    n_bc = s.n_groups * s.state_dim

    if cache is not None and index is not None:
        # -------- decode: O(1) recurrent update --------------------------
        xp = torch.cat([cache["conv"], xBC], dim=1)       # (B, W, conv_dim)
        xBC_t = F.silu(
            torch.einsum("bwc,wc->bc", xp.to(f32), p["conv_w"].to(f32))
            + p["conv_b"].to(f32)).to(dt_)
        xs, Bm, Cm = torch.split(xBC_t, [d_in, n_bc, n_bc], dim=-1)
        xs = xs.reshape(B, H, s.head_dim).to(f32)
        rep = H // s.n_groups
        Bm = torch.repeat_interleave(
            Bm.reshape(B, s.n_groups, s.state_dim), rep, dim=1)
        Cm = torch.repeat_interleave(
            Cm.reshape(B, s.n_groups, s.state_dim), rep, dim=1)
        A = -torch.exp(p["a_log"].to(f32))
        da = torch.exp(dt[:, 0] * A)                      # (B,H)
        state = cache["state"] * da[..., None, None] + torch.einsum(
            "bhn,bhp->bhpn", Bm.to(f32) * dt[:, 0, :, None], xs)
        y = torch.einsum("bhn,bhpn->bhp", Cm.to(f32), state)
        y = y + xs * p["d_skip"].to(f32)[None, :, None]
        y = y.reshape(B, 1, d_in)
        cache["conv"].copy_(xp[:, 1:])
        cache["state"].copy_(state)
        new_cache = {"conv": cache["conv"], "state": cache["state"]}
    else:
        # -------- train / prefill -----------------------------------------
        tail = conv_tail(xBC, s.conv_width) if want_cache else None
        xBC = causal_conv1d(xBC, p["conv_w"], p["conv_b"])
        xs, Bm, Cm = torch.split(xBC, [d_in, n_bc, n_bc], dim=-1)
        S = x.shape[1]
        xs = xs.reshape(B, S, H, s.head_dim)
        Bm = Bm.reshape(B, S, s.n_groups, s.state_dim)
        Cm = Cm.reshape(B, S, s.n_groups, s.state_dim)
        xs = shard(xs, "batch", "seq", "ssm_heads", None)
        y, fstate = ssd_chunked(xs, dt, p["a_log"], Bm, Cm, p["d_skip"],
                                s.chunk_size, return_state=True)
        y = y.reshape(B, S, d_in)
        new_cache = None
        if want_cache:
            new_cache = {"conv": tail, "state": fstate}

    # gated RMSNorm + out proj
    g = y.to(f32) * F.silu(z.to(f32))
    ms = g.square().mean(dim=-1, keepdim=True)
    g = g * torch.rsqrt(ms + cfg.norm_eps) * p["norm_scale"].to(f32)
    out = g.to(dt_) @ p["wout"].to(dt_)
    return shard(out, "batch", "seq", "embed"), new_cache
