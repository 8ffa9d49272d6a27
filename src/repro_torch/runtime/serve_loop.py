"""Serve-step construction: prefill and decode (port of
``repro/runtime/serve_loop.py``).

``decode_step`` takes the KV caches, writes the new token's K/V into them
and returns them (the reference donates them); ``index`` is the absolute
position being written (the cache already holds positions < index).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.model_zoo import Model


def make_prefill_step(model: Model):
    def prefill_step(params, batch) -> Tuple[torch.Tensor, Any]:
        logits, caches = model.prefill(params, batch)
        return logits, caches

    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, caches, batch) -> Tuple[torch.Tensor, Any]:
        logits, caches = model.decode(params, caches, batch)
        return logits, caches

    return decode_step


def pad_caches(model: Model, caches, batch_size: int, target_len: int):
    """Grow prefill caches to a decode-capacity length.

    Pads every leaf with zeros up to the shape of ``model.cache_meta(batch,
    target)``; padded positions are masked by ``index`` during decode.
    Ring-buffer local-window caches and recurrent states are already
    final-size, and so are an encoder-decoder's cross K/V (the ``cross``
    subtree): they hold the encoder memory, whose length decode does not
    change.  The reference pads those too, with zero keys that its cross
    attention does not mask (ROADMAP queue 3 item 18); here they stay as
    the prefill left them.
    """
    target_meta = model.cache_meta(batch_size, target_len)

    def pad(m, leaf):
        pads = [t - s for s, t in zip(leaf.shape, m.shape)]
        if any(p < 0 for p in pads):
            raise ValueError(f"cache {tuple(leaf.shape)} is larger than "
                             f"{m.shape}")
        if any(pads):
            # F.pad lists (before, after) pairs from the last dim back
            return F.pad(leaf, [x for p in reversed(pads) for x in (0, p)])
        return leaf

    def walk(m, c):
        if not isinstance(m, dict):
            return pad(m, c)
        return {k: c[k] if k == "cross" else walk(m[k], c[k])
                for k in sorted(m)}

    return walk(target_meta, caches)
