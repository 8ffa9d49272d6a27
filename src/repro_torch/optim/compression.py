"""Gradient compression for the DP all-reduce (port of
``repro/optim/compression.py``).

Two schemes, both with exact-shape dense decompression so they can sit in
front of any collective:

* **error-feedback top-k**: keep the k largest-|g| entries per tensor,
  feed the rest into a residual that is added back next step, so the
  compression error does not accumulate.  Every entry at least as large
  as the k-th largest is kept, so ties at the threshold keep all their
  entries, as in the reference.
* **int8 quantisation** with a per-tensor symmetric scale (the
  dequantised result is what the update uses).

They are pure functions on tensor trees, used by the train step when
``TrainSettings.compression != "none"``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.params import tree_leaves, tree_map

f32 = torch.float32


class CompressionState(NamedTuple):
    error: Any  # tree of residuals, same structure as the grads


def compress_topk_init(grads_like) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda g: torch.zeros(g.shape, dtype=f32, device=g.device),
        grads_like))


def _topk_dense(x: torch.Tensor, k: int) -> torch.Tensor:
    """Zero all but the k largest-|x| entries (dense output; entries tied
    with the k-th largest are kept too)."""
    flat = x.reshape(-1)
    k = max(1, min(k, flat.shape[0]))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    kept = torch.where(torch.abs(flat) >= thresh, flat,
                       torch.zeros((), dtype=flat.dtype, device=flat.device))
    return kept.reshape(x.shape)


def ef_topk_compress_decompress(
    grads, state: CompressionState, ratio: float = 0.01
) -> Tuple[Any, CompressionState, Dict[str, torch.Tensor]]:
    """Error-feedback top-k.  Returns (dense decompressed grads, new state,
    stats with the compressed-bytes fraction)."""

    def one(g, e):
        acc = g.to(f32) + e
        k = max(1, int(ratio * acc.numel()))
        kept = _topk_dense(acc, k)
        return kept.to(g.dtype), acc - kept

    out = tree_map(one, grads, state.error)
    kept = tree_map(lambda t: t[0], out)
    err = tree_map(lambda t: t[1], out)
    # transmitted payload: k values + k int32 indices per tensor
    leaves = tree_leaves(grads)
    total = sum(g.numel() for g in leaves)
    sent = sum(max(1, int(ratio * g.numel())) * 2 for g in leaves)
    dev = leaves[0].device if leaves else None
    stats = {"bytes_fraction": torch.full((), sent / max(total, 1),
                                          dtype=f32, device=dev)}
    return kept, CompressionState(error=err), stats


def int8_compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.amax(torch.abs(x.to(f32))), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x.to(f32) / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(f32) * scale
