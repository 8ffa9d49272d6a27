"""Graph motif — computation on nodes/edges with data dependencies (port of
``repro/core/motifs/graph.py``).

Paper Table III implementations covered:
* ``construct``     (graph construction: CSR-like build from an edge list)
* ``traversal``     (frontier-expansion BFS)
* ``pagerank_iter`` (the PageRank hotspot: one power-iteration step)

``jax.ops.segment_sum`` becomes ``index_add_`` (f32 adds through atomics
on CUDA, so their order varies); ``segment_max`` becomes
``scatter_reduce_(..., "amax")`` onto the reference's empty-segment value,
int32's minimum, which is nonzero: a vertex with no in-edge counts as
reached, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.motifs.base import (Motif, PVector, register,
                                          segment_count, segment_sum)
from repro_torch.data.generators import gen_graph, make_generator
from repro_torch.device import resolve_device

_INT32_MIN = -(1 << 31)


@register
class GraphMotif(Motif):
    name = "graph"
    variants = ("construct", "traversal", "pagerank_iter")
    default_variant = "traversal"
    tunable = ("data_size", "chunk_size", "num_tasks", "weight")
    data_kind = "graph"

    def _sizes(self, p: PVector):
        e = int(max(p.data_size, 256))
        v = int(max(e // 8, 16))
        return v, e

    def make_inputs(self, p: PVector, seed: int,
                    device: Optional[torch.device] = None) -> Dict[str, Any]:
        dev = resolve_device(device)
        v, e = self._sizes(p)
        src, dst = gen_graph(make_generator(seed, dev), v, e, p.spec())
        # filled in on the device: a host copy would break a graph capture
        return {"src": src, "dst": dst,
                "num_vertices": torch.scalar_tensor(v, dtype=torch.int32,
                                                    device=dev)}

    def apply(self, p: PVector, inputs: Dict[str, Any], variant: str = "") -> Any:
        var = self.resolve_variant(variant)
        src, dst = inputs["src"], inputs["dst"]
        v, _ = self._sizes(p)

        out_deg = segment_count(src, v)
        if var == "construct":
            # CSR build: sort edges by src (stable, as jnp.argsort),
            # prefix-sum degrees -> row offsets
            order = torch.argsort(src, stable=True)
            offsets = torch.cat([
                torch.zeros(1, dtype=torch.int32, device=src.device),
                torch.cumsum(out_deg, 0, dtype=torch.int32)])
            return {"col": dst[order], "offsets": offsets, "out_deg": out_deg}

        if var == "traversal":
            iters = max(min(int(p.chunk_size).bit_length(), 12), 4)
            frontier = torch.zeros(v, dtype=torch.bool, device=src.device)
            # the root, filled in on the device: setting a Python bool
            # copies it from the host, which a graph capture refuses
            frontier[0] = torch.scalar_tensor(True, dtype=torch.bool,
                                              device=src.device)
            dst64 = dst.to(torch.int64)
            for _ in range(iters):
                active = frontier[src].to(torch.int32)
                reached = torch.full((v,), _INT32_MIN, dtype=torch.int32,
                                     device=src.device).scatter_reduce_(
                    0, dst64, active, "amax", include_self=True)
                frontier = frontier | reached.to(torch.bool)
            return {"visited": frontier,
                    "count": torch.sum(frontier, dtype=torch.int32)}

        # pagerank_iter: r' = (1-d)/V + d * sum_in r[src]/deg[src]
        d = 0.85
        r = torch.full((v,), 1.0 / v, dtype=torch.float32, device=src.device)
        deg = torch.clamp_min(out_deg.to(torch.float32), 1.0)
        iters = max(min(int(p.num_tasks), 8), 2)
        for _ in range(iters):
            r = (1.0 - d) / v + d * segment_sum(r[src] / deg[src], dst, v)
        return {"rank": r, "rank_sum": torch.sum(r)}
