"""Hadoop K-means in PyTorch (CPU+memory-intensive; sparse vectors); port of
``repro/workloads/kmeans.py``.

One Lloyd iteration over BDGS-style sparse vectors (90% sparsity, the
paper's configuration).  At ``scale=1.0`` that is 400,000 x 64 f32
points and 32 centroids.

Paper Table III motifs: Matrix (euclidean distance), Statistics (cluster
count + average), Sort (cluster ordering).
"""
from __future__ import annotations

import torch

from repro_torch.core.decompose import MotifHint
from repro_torch.data.generators import DataSpec, gen_vectors
from repro_torch.device import full_f32
from repro_torch.distributed.spmd import replicated
from repro_torch.workloads.base import Workload, register_workload

DIM = 64
K = 32


def make_inputs(gen: torch.Generator, scale: float = 1.0,
                sparsity: float = 0.9):
    n = max(int(400_000 * scale), 2_048)
    spec = DataSpec(distribution="normal", sparsity=sparsity)
    x = gen_vectors(gen, n, DIM, spec)
    centroids = gen_vectors(gen, K, DIM, DataSpec(distribution="normal"))
    return (x, centroids)


@full_f32()  # the reference's products are full f32
def step(x: torch.Tensor, centroids: torch.Tensor):
    # assign: euclidean distances through one matrix product (matrix motif)
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(centroids * centroids, dim=-1)
    d = x2 - 2.0 * (x @ centroids.T) + c2[None, :]
    assign = torch.argmin(d, dim=-1)  # first index on ties, as jnp.argmin

    # update: one-hot matmul cluster sums + counts (statistics motif); the
    # one-hot is a compare, as jax.nn.one_hot, so no host sync
    k = centroids.shape[0]
    onehot = (assign[:, None] == torch.arange(k, device=x.device)).to(x.dtype)
    sums = onehot.T @ x
    # sharded points: the counts are made whole once, for every use
    counts = replicated(torch.sum(onehot, dim=0))
    new_centroids = sums / torch.clamp_min(counts[:, None], 1.0)

    # the Hadoop reduce side emits clusters sorted by size (sort motif);
    # counts tie, so the order must be stable like jnp.argsort
    order = torch.argsort(counts, stable=True)
    inertia = torch.sum(torch.amin(d, dim=-1))
    return new_centroids[order], counts[order], inertia


HINTS = (
    MotifHint("matrix", "euclidean", 0.50),
    MotifHint("statistics", "average", 0.30),
    MotifHint("sort", "quick", 0.20),
)

KMEANS = register_workload(Workload(
    name="kmeans",
    make_inputs=make_inputs,
    step=step,
    hints=HINTS,
    input_axes=("batch", None),
))
