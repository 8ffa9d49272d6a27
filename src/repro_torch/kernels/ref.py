"""Plain PyTorch versions of the hand-written kernels (port of
``repro/kernels/ref.py``): the oracles the kernels are held against, and
what a kernel wrapper runs for a tensor on the CPU."""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.uint32 import full, narrow, widen


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x @ y computed in f32, cast to x's dtype."""
    return torch.matmul(x.to(torch.float32), y.to(torch.float32)).to(x.dtype)


def row_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (mean, mean-of-squares) over the last dim, f32."""
    xf = x.to(torch.float32)
    return torch.mean(xf, dim=-1), torch.mean(xf * xf, dim=-1)


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x·rsqrt(mean(x²) + eps)·w`` over the last dim in f32, cast to
    x's dtype."""
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.to(torch.float32)).to(x.dtype)


def sort(x: torch.Tensor) -> torch.Tensor:
    return narrow(torch.sort(widen(x)).values, x.dtype)


def sort_blocks(x: torch.Tensor, block: int, sentinel) -> torch.Tensor:
    """Each ``block``-sized run of 1-D ``x`` sorted, padded with
    ``sentinel`` up to a whole number of blocks (the output of
    ``bitonic_sort_blocks``)."""
    n = x.shape[0]
    pad = (-n) % block
    if pad:
        x = torch.cat([x, full((pad,), sentinel, x.dtype, x.device)])
    runs = torch.sort(widen(x).reshape(-1, block), dim=-1).values
    return narrow(runs.reshape(-1), x.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Dense softmax attention in f32, (B, S, H, D) or (S, D) layouts.

    The causal mask keeps ``k_idx <= q_idx`` with both counted from 0
    (top-left aligned, also when Sq != Skv); masked scores are -1e30."""
    single = q.ndim == 2
    if single:
        q, k, v = q[None, :, None], k[None, :, None], v[None, :, None]
    D = q.shape[-1]
    Sq, Skv = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(D)
    if causal:
        mask = (torch.arange(Skv, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    out = out.to(q.dtype)
    return out[0, :, 0] if single else out


def moe_dispatch(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """mask (T, E, C), x (T, D) -> (E, C, D) expert buckets, in f32, cast
    to x's dtype."""
    return torch.einsum("tec,td->ecd", mask.to(torch.float32),
                        x.to(torch.float32)).to(x.dtype)
