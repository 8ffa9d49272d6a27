"""Matrix motif — vector-vector / vector-matrix / matrix-matrix computation
(port of ``repro/core/motifs/matrix.py``).

Paper Table III implementations covered:
* ``euclidean`` / ``cosine``  (K-means distance hotspots)
* ``construct`` / ``matmul``  (PageRank matrix construction + multiplication)
* ``fully_connected``         (AlexNet / Inception-V3 dense layers)

The reference maps a per-chunk body over tasks and chunks; every row of
those bodies is independent, so here each variant is one batched
computation over the ``(tasks·per·chunk, dim)`` rows of the chunk layout.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.motifs.base import Motif, PVector, chunked, combine, register
from repro_torch.data.generators import gen_vectors, make_generator
from repro_torch.device import resolve_device


def _dims(p: PVector):
    """data_size elements -> (rows, dim) with dim tied to chunk_size."""
    dim = int(max(min(p.chunk_size, 2048), 8))
    rows = int(max(p.data_size // dim, 8))
    return rows, dim


def chunk_rows(p: PVector, x: torch.Tensor) -> torch.Tensor:
    """The rows the chunk layout keeps, as one ``(tasks·per·chunk, dim)``
    matrix (the combined order of the per-chunk outputs)."""
    xc = chunked(p, x)  # (tasks, per, chunk_rows, dim)
    return xc.reshape(-1, xc.shape[-1])


@register
class MatrixMotif(Motif):
    name = "matrix"
    variants = ("euclidean", "cosine", "construct", "matmul", "fully_connected")
    default_variant = "matmul"
    tunable = ("data_size", "chunk_size", "num_tasks", "weight", "batch_size")

    def make_inputs(self, p: PVector, seed: int,
                    device: Optional[torch.device] = None) -> Dict[str, Any]:
        gen = make_generator(seed, resolve_device(device))
        rows, dim = _dims(p)
        x = gen_vectors(gen, rows, dim, p.spec())
        k = max(min(p.batch_size, rows), 2)
        centroids = gen_vectors(gen, k, dim, p.spec())
        w = gen_vectors(gen, dim, dim, p.spec())
        return {"x": x, "centroids": centroids, "w": w}

    def apply(self, p: PVector, inputs: Dict[str, Any], variant: str = "") -> Any:
        v = self.resolve_variant(variant)
        x, c, w = inputs["x"], inputs["centroids"], inputs["w"]

        if v == "euclidean":
            # K-means assign step: ||x-c||^2 = ||x||^2 - 2 x.c + ||c||^2
            rows = chunk_rows(p, x)
            c2 = torch.sum(c * c, dim=-1)
            x2 = torch.sum(rows * rows, dim=-1, keepdim=True)
            d = x2 - 2.0 * (rows @ c.T) + c2[None, :]
            return {"assign": torch.argmin(d, dim=-1).to(torch.int32),
                    "dist": torch.amin(d, dim=-1)}

        if v == "cosine":
            xn = x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-6)
            cn = c / (torch.linalg.norm(c, dim=-1, keepdim=True) + 1e-6)
            sim = xn @ cn.T
            return {"assign": torch.argmax(sim, dim=-1).to(torch.int32),
                    "sim_max": torch.amax(sim, dim=-1)}

        if v == "construct":
            # build a normalized transition-like matrix from row blocks
            xc = chunked(p, x)
            sums = torch.sum(torch.abs(xc), dim=-1, keepdim=True) + 1e-6
            return {"m": combine(xc / sums)}

        if v == "matmul":
            return {"y": chunk_rows(p, x) @ w}

        # fully_connected: batched x @ W + b with nonlinearity
        b = torch.zeros((w.shape[-1],), dtype=x.dtype, device=x.device)
        return {"y": torch.relu(chunk_rows(p, x) @ w + b)}
