"""RG-LRU recurrent block (Griffin / RecurrentGemma; port of
``repro/models/rglru.py``).  [arXiv:2402.19427]

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t ⊙ x_t),
a_t = exp(-c * softplus(Λ) * r_t), r/i input gates, c = 8.

Prefill runs the recurrence as a parallel scan over the sequence: where
the reference calls ``lax.associative_scan`` with the combine
``(la1, b1), (la2, b2) -> (la1 + la2, b1 * exp(la2) + b2)``, the port
runs :func:`linear_scan`, ⌈log2 S⌉ doubling passes of the same combine
(stable: ``log_a <= 0``).  Decode is a single O(1) update that writes the
new conv tail and ``h`` into the cache tensors it is given and returns
them; it reads nothing back to the host.

The prefill caches the conv's *input* (the last ``conv_width - 1`` rows
of ``x @ w1``), which decode convolves with the next token's; the
reference caches the conv's output (ROADMAP queue 3 item 18).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RGLRUConfig
from repro_torch.data.generators import torch_dtype
from repro_torch.distributed import shard
from repro_torch.models.mamba2 import causal_conv1d, conv_tail
from repro_torch.models.params import meta

f32 = torch.float32
_C = 8.0


def _width(cfg: ModelConfig) -> int:
    r: RGLRUConfig = cfg.rglru or RGLRUConfig()
    return r.lru_width or cfg.d_model


def rglru_block_meta(cfg: ModelConfig) -> Dict[str, Any]:
    r: RGLRUConfig = cfg.rglru or RGLRUConfig()
    d, w = cfg.d_model, _width(cfg)
    pd = torch_dtype(cfg.param_dtype)
    return {
        "w1": meta((d, w), ("embed", "lru_width"), dtype=pd, fan_in=d),
        "w2": meta((d, w), ("embed", "lru_width"), dtype=pd, fan_in=d),
        "conv_w": meta((r.conv_width, w), ("conv", "lru_width"), dtype=pd,
                       fan_in=r.conv_width),
        "conv_b": meta((w,), ("lru_width",), init="zeros", dtype=pd),
        "wa": meta((w, w), ("lru_width", None), dtype=pd, fan_in=w),
        "ba": meta((w,), ("lru_width",), init="zeros", dtype=pd),
        "wi": meta((w, w), ("lru_width", None), dtype=pd, fan_in=w),
        "bi": meta((w,), ("lru_width",), init="zeros", dtype=pd),
        "lam": meta((w,), ("lru_width",), init="ones", dtype=f32),
        "wout": meta((w, d), ("lru_width", "embed"), dtype=pd, fan_in=w),
    }


def rglru_cache_meta(cfg: ModelConfig, batch: int) -> Dict[str, Any]:
    r: RGLRUConfig = cfg.rglru or RGLRUConfig()
    w = _width(cfg)
    return {
        "conv": meta((batch, r.conv_width - 1, w),
                     ("batch", None, "lru_width"), init="zeros",
                     dtype=torch_dtype(cfg.dtype)),
        "h": meta((batch, w), ("batch", "lru_width"), init="zeros", dtype=f32),
    }


def _gates(p, x1: torch.Tensor):
    """x1: (..., w) f32 post-conv branch -> (log_a, b) of the recurrence."""
    r = torch.sigmoid(x1 @ p["wa"].to(f32) + p["ba"].to(f32))
    i = torch.sigmoid(x1 @ p["wi"].to(f32) + p["bi"].to(f32))
    log_a = -_C * F.softplus(p["lam"].to(f32)) * r
    mult = torch.sqrt(-torch.expm1(2.0 * log_a) + 1e-12)
    b = mult * (i * x1)
    return log_a, b


def linear_scan(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h[t] = exp(log_a[t]) * h[t-1] + b[t]`` from ``h[-1] = 0`` along
    dim 1 of (B, S, ...) tensors: an inclusive scan of the combine
    ``(la1, b1), (la2, b2) -> (la1 + la2, b1 * exp(la2) + b2)`` in
    ⌈log2 S⌉ doubling passes (after the pass of stride k, position t
    holds the combine of the 2k positions up to t)."""
    la, h = log_a, b
    k, S = 1, b.shape[1]
    while k < S:
        h = torch.cat([h[:, :k], h[:, :-k] * torch.exp(la[:, k:]) + h[:, k:]],
                      dim=1)
        la = torch.cat([la[:, :k], la[:, :-k] + la[:, k:]], dim=1)
        k *= 2
    return h


def rglru_block_apply(
    p, cfg: ModelConfig, x: torch.Tensor, *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    index: Optional[torch.Tensor] = None,
    want_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The block's output (B, S, d).  Decode (``cache`` and ``index``)
    writes the new conv tail and ``h`` into ``cache``'s tensors and
    returns them; a prefill with ``want_cache`` returns new ones."""
    dt_ = torch_dtype(cfg.dtype)
    x1 = x @ p["w1"].to(dt_)
    x2 = x @ p["w2"].to(dt_)
    x1 = shard(x1, "batch", "seq", "lru_width")

    if cache is not None and index is not None:
        # -------- decode ---------------------------------------------------
        xp = torch.cat([cache["conv"], x1], dim=1)
        x1c = F.silu(
            torch.einsum("bwc,wc->bc", xp.to(f32), p["conv_w"].to(f32))
            + p["conv_b"].to(f32))
        log_a, b = _gates(p, x1c)
        h = cache["h"] * torch.exp(log_a) + b             # (B, w)
        y = h[:, None]
        cache["conv"].copy_(xp[:, 1:])
        cache["h"].copy_(h)
        new_cache = {"conv": cache["conv"], "h": cache["h"]}
    else:
        # -------- train / prefill ------------------------------------------
        tail = conv_tail(x1, cfg.rglru.conv_width) if want_cache else None
        x1 = causal_conv1d(x1, p["conv_w"], p["conv_b"])
        log_a, b = _gates(p, x1.to(f32))
        h = linear_scan(log_a, b)
        y = h
        new_cache = None
        if want_cache:
            new_cache = {"conv": tail.to(dt_), "h": h[:, -1].clone()}

    gate = F.gelu(x2.to(f32), approximate="tanh")
    out = (y * gate).to(dt_) @ p["wout"].to(dt_)
    return shard(out, "batch", "seq", "embed"), new_cache
