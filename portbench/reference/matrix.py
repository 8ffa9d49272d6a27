"""Plain reference of the matrix motif (K-means distances, PageRank's
matrices, dense layers).

Rows are data_size elements cut into vectors of ``dim`` = chunk_size
(clamped to [8, 2048]); the chunk layout keeps whole (task, chunk)
blocks of them.  ``euclidean`` and ``cosine`` assign each row to a
centroid; the reference returns the distance or similarity matrix beside
the assignment, so the comparison can judge a chosen index by how far
its score lies from the best one.
"""
from __future__ import annotations

import torch

from portbench.reference.arith import compute_dtype, mm
from portbench.reference.gen import (chunk_layout, chunked, generator,
                                     vectors)

VARIANTS = ("euclidean", "cosine", "construct", "matmul", "fully_connected")
DEFAULT = "matmul"


def dims(p):
    """(rows, dim) of the motif's vectors."""
    dim = int(max(min(p.chunk_size, 2048), 8))
    return int(max(p.data_size // dim, 8)), dim


def centroids(p) -> int:
    return max(min(p.batch_size, dims(p)[0]), 2)


def inputs(p, seed: int, device: torch.device) -> dict:
    gen = generator(seed, device)
    rows, dim = dims(p)
    x = vectors(gen, rows, dim, p)
    c = vectors(gen, centroids(p), dim, p)
    w = vectors(gen, dim, dim, p)
    return {"x": x, "centroids": c, "w": w}


def _rows(x: torch.Tensor, p) -> torch.Tensor:
    xc = chunked(x, p)
    return xc.reshape(-1, xc.shape[-1])


def apply(p, inputs: dict, variant: str, precision: str):
    dt = compute_dtype(precision)
    out_dt = inputs["x"].dtype
    x, c, w = (inputs[k].to(dt) for k in ("x", "centroids", "w"))

    if variant == "euclidean":
        rows = _rows(x, p)
        d = (torch.sum(rows * rows, -1, keepdim=True)
             - 2.0 * mm(rows, c.T, precision)
             + torch.sum(c * c, -1)[None, :])
        return ({"assign": torch.argmin(d, -1).to(torch.int32),
                 "dist": torch.amin(d, -1).to(out_dt)},
                {"assign": (d, "min")})
    if variant == "cosine":
        xn = x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-6)
        cn = c / (torch.linalg.norm(c, dim=-1, keepdim=True) + 1e-6)
        sim = mm(xn, cn.T, precision)
        return ({"assign": torch.argmax(sim, -1).to(torch.int32),
                 "sim_max": torch.amax(sim, -1).to(out_dt)},
                {"assign": (sim, "max")})
    if variant == "construct":
        xc = chunked(x, p)
        m = xc / (torch.sum(torch.abs(xc), -1, keepdim=True) + 1e-6)
        return {"m": m.reshape(-1, m.shape[-1]).to(out_dt)}, {}
    y = mm(_rows(x, p), w, precision)
    if variant == "fully_connected":
        y = torch.relu(y)  # the bias is zero
    return {"y": y.to(out_dt)}, {}


def flops(p, variant: str) -> float:
    """Arithmetic of one invocation: a multiply-add counts 2, any other
    arithmetic step on an element 1."""
    rows, dim = dims(p)
    tasks, per, chunk = chunk_layout(rows, p)
    used, k = tasks * per * chunk, centroids(p)
    if variant == "euclidean":
        return 2.0 * used * k * dim + 2.0 * (used + k) * dim + 3.0 * used * k
    if variant == "cosine":
        return 2.0 * rows * k * dim + 3.0 * (rows + k) * dim
    if variant == "construct":
        return 3.0 * used * dim
    if variant == "matmul":
        return 2.0 * used * dim * dim
    return 2.0 * used * dim * dim + used * dim  # fully_connected: + bias


def products(p, variant: str) -> int:
    """Matrix products of one invocation."""
    return 0 if variant == "construct" else 1
