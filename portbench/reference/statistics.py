"""Plain reference of the statistics motif (K-means' count and average,
PageRank's degrees, batch normalisation, softmax).

Counts are int32 and exact.  ``average`` is the per-feature mean and
population variance over the rows the chunk layout keeps; ``batchnorm``
normalises each channel over the batch and the image.
"""
from __future__ import annotations

import torch

from portbench.reference.arith import compute_dtype
from portbench.reference.gen import (chunk_layout, chunked, generator, graph,
                                     images, vectors)

VARIANTS = ("count", "average", "degree", "batchnorm", "softmax")
DEFAULT = "average"


def dims(p):
    dim = max(min(int(p.chunk_size), 1024), 8)
    return max(int(p.data_size) // dim, 8), dim


def vertices(p) -> int:
    return max(int(p.data_size) // 64, 16)


def inputs(p, seed: int, device: torch.device) -> dict:
    gen = generator(seed, device)
    rows, dim = dims(p)
    x = vectors(gen, rows, dim, p)
    labels = (torch.randint(0, 1 << 32, (rows,), generator=gen, device=device)
              % max(p.channels, 2)).to(torch.int32)
    src, dst = graph(gen, vertices(p), int(max(p.data_size, 256)), p)
    return {"x": x, "labels": labels, "src": src, "dst": dst,
            "images": images(gen, p)}


def _count(ids: torch.Tensor, n: int) -> torch.Tensor:
    return torch.bincount(ids.to(torch.int64), minlength=n).to(torch.int32)


def apply(p, inputs: dict, variant: str, precision: str):
    dt = compute_dtype(precision)
    if variant == "count":
        return {"counts": _count(inputs["labels"], max(p.channels, 2))}, {}
    if variant == "degree":
        n = vertices(p)
        in_deg = _count(inputs["dst"], n)
        return {"out_deg": _count(inputs["src"], n), "in_deg": in_deg,
                "max_in": torch.amax(in_deg)}, {}
    if variant == "average":
        x = inputs["x"]
        xc = chunked(x.to(dt), p)
        rows = xc.reshape(-1, xc.shape[-1])
        var, mean = torch.var_mean(rows, dim=0, correction=0)
        return {"mean": mean.to(x.dtype), "var": var.to(x.dtype)}, {}
    if variant == "batchnorm":
        img = inputs["images"]
        axes = (0, 1, 2) if p.layout == "NHWC" else (0, 2, 3)
        x = img.to(dt)
        var, mean = torch.var_mean(x, dim=axes, keepdim=True, correction=0)
        return {"y": ((x - mean) * torch.rsqrt(var + 1e-5)).to(img.dtype)}, {}
    x = inputs["x"]  # softmax over the feature dim
    return {"probs": torch.softmax(x.to(dt), dim=-1).to(x.dtype)}, {}


def flops(p, variant: str) -> float:
    """Arithmetic of one invocation, each step on an element counted 1."""
    rows, dim = dims(p)
    if variant == "average":
        tasks, per, chunk = chunk_layout(rows, p)
        return 3.0 * tasks * per * chunk * dim  # add, square, add
    if variant == "batchnorm":  # mean 1, variance 3, normalise 2
        return 6.0 * max(p.batch_size, 1) * p.height * p.width * p.channels
    if variant == "softmax":  # max, subtract and exp, sum, divide
        return 4.0 * rows * dim
    return 0.0  # count, degree: integer counting
