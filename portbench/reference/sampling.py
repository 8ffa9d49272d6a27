"""Plain reference of the sampling motif (TeraSort's partition sampling,
pooling, dropout, top-k routing).

``random``, ``dropout`` and ``topk`` draw from the int32 seed the node's
inputs carry: a generator seeded with its value.  Pooling windows are
2x2 with stride 2, and every image result is NHWC.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.arith import compute_dtype
from portbench.reference.gen import (generator, images, keys, seed_leaf,
                                     u32_from_i64, vectors)

VARIANTS = ("random", "interval", "maxpool", "avgpool", "dropout", "topk")
DEFAULT = "random"


def inputs(p, seed: int, device: torch.device) -> dict:
    gen = generator(seed, device)
    return {"keys": keys(gen, int(p.data_size), p), "rng": seed_leaf(gen),
            "images": images(gen, p)}


def _own_generator(inputs: dict) -> torch.Generator:
    rng = inputs["rng"]
    return generator(int(rng), rng.device)


def apply(p, inputs: dict, variant: str, precision: str):
    k = inputs["keys"]
    n = k.shape[0]
    if variant == "random":
        m = max(n // 64, 1)
        gen = _own_generator(inputs)
        idx = torch.randint(0, n, (m,), generator=gen, device=gen.device)
        sample = torch.sort(k.to(torch.int64)[idx]).values
        return {"splits": u32_from_i64(sample[:: max(m // 16, 1)])}, {}
    if variant == "interval":
        return {"sample": k[:: max(int(p.chunk_size) % 97 + 2, 2)]}, {}
    if variant == "topk":
        gen = _own_generator(inputs)
        scores = vectors(gen, n // max(p.channels, 1) + 1,
                         max(p.channels, 2), p)
        vals, idx = torch.topk(scores, k=min(2, scores.shape[-1]), dim=-1)
        return {"vals": vals, "idx": idx.to(torch.int32)}, {}
    img = inputs["images"]
    x = img.permute(0, 2, 3, 1) if p.layout == "NCHW" else img
    if variant == "dropout":
        gen = _own_generator(inputs)
        keep = torch.rand(x.shape, generator=gen, device=gen.device) < 0.5
        return {"y": torch.where(keep, x * 2.0, torch.zeros_like(x))}, {}
    pool = F.max_pool2d if variant == "maxpool" else F.avg_pool2d
    y = pool(x.to(compute_dtype(precision)).permute(0, 3, 1, 2), 2, 2)
    return {"y": y.permute(0, 2, 3, 1).to(img.dtype)}, {}


def flops(p, variant: str) -> float:
    """Arithmetic of one invocation, each step on an element counted 1."""
    pixels = max(p.batch_size, 1) * p.height * p.width * p.channels
    if variant in ("avgpool", "dropout"):
        return float(pixels)
    return 0.0  # sampling, comparisons and moves
