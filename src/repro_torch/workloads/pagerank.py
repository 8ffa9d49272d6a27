"""Hadoop PageRank in PyTorch (CPU+I/O-intensive; power-law graph); port of
``repro/workloads/pagerank.py``.

``scale=1.0`` is 262,144 vertices and 4,194,304 zipf edges (average
degree 16).  One step = one power iteration plus the degree-statistics
and matrix-construction footprints the paper's decomposition names.
``segment_sum`` becomes ``index_add_``: f32 adds through atomics on
CUDA, so ranks are held with allclose, never bit equality.

Paper Table III motifs: Matrix (construct/multiply), Sort (min/max),
Statistics (in/out-degree counts).
"""
from __future__ import annotations

import torch

from repro_torch.core.decompose import MotifHint
from repro_torch.core.motifs.base import segment_count, segment_sum
from repro_torch.data.generators import DataSpec, gen_graph
from repro_torch.workloads.base import Workload, register_workload

AVG_DEGREE = 16
DAMPING = 0.85


def make_inputs(gen: torch.Generator, scale: float = 1.0):
    v = max(int((1 << 18) * scale), 1 << 12)
    src, dst = gen_graph(gen, v, v * AVG_DEGREE, DataSpec(distribution="zipf"))
    ranks = torch.full((v,), 1.0 / v, dtype=torch.float32, device=gen.device)
    return (src, dst, ranks)


def step(src: torch.Tensor, dst: torch.Tensor, ranks: torch.Tensor):
    v = ranks.shape[0]
    # statistics: degree counting (the map-side bookkeeping)
    out_deg = segment_count(src, v)
    in_deg = segment_count(dst, v)

    # matrix construct+multiply: normalized contributions pushed over edges
    deg = torch.clamp_min(out_deg.to(ranks.dtype), 1.0)
    agg = segment_sum(ranks[src] / deg[src], dst, v)
    new_ranks = (1.0 - DAMPING) / v + DAMPING * agg

    # sort: min/max rank extraction (Hadoop PageRank's reducer output)
    top = torch.topk(new_ranks, 16).values
    delta = torch.amax(torch.abs(new_ranks - ranks))
    return new_ranks, top, delta, in_deg


HINTS = (
    MotifHint("matrix", "construct", 0.35),
    MotifHint("graph", "pagerank_iter", 0.35),
    MotifHint("sort", "minmax", 0.10),
    MotifHint("statistics", "degree", 0.20),
)

PAGERANK = register_workload(Workload(
    name="pagerank",
    make_inputs=make_inputs,
    step=step,
    hints=HINTS,
    input_axes=("batch", "batch", None),
))
