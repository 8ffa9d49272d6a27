"""Hadoop TeraSort in PyTorch (I/O-intensive; text records); port of
``repro/workloads/terasort.py``.

gensort emits 100-byte records (10-byte key + 90-byte payload); the
reference keeps the ratio with a uint32 key + 24 uint32 payload words, so
``scale=1.0`` is 2,000,000 records, 200 MB.  The step mirrors Hadoop's
phases:

1. *sampling*   — sample keys, sort the sample, pick partition splits
                  (TeraSort's TotalOrderPartitioner);
2. *shuffle*    — assign each record to a partition (searchsorted) and
                  lay the partitions out (the graph-construction footprint);
3. *sort+merge* — global key sort carrying the payload.

Keys and payload stay uint32; the sort, search and gathers go through
``repro_torch.uint32`` (CUDA torch has none of them for uint32).  The
argsort is stable, as ``jnp.argsort``: 2M random keys repeat.

Paper decomposition: 70% sort, 10% sampling, 20% graph (§II-B2).
"""
from __future__ import annotations

import torch

from repro_torch.core.decompose import MotifHint
from repro_torch.data.generators import DataSpec, gen_text_records
from repro_torch.distributed.spmd import bincount as spmd_bincount
from repro_torch.distributed.spmd import is_dtensor, replicated
from repro_torch.uint32 import take, widen
from repro_torch.workloads.base import Workload, register_workload

PAYLOAD_WORDS = 24  # 4B key + 96B payload ~ gensort's 100B record
NUM_PARTS = 64


def make_inputs(gen: torch.Generator, scale: float = 1.0):
    n = max(int(2_000_000 * scale), 4_096)
    return gen_text_records(gen, n, PAYLOAD_WORDS, DataSpec())


def step(keys: torch.Tensor, payload: torch.Tensor):
    n = keys.shape[0]
    # sharded records: the keys are gathered once, for the sample, the
    # partition search and the global order, as the reference's
    # partitioner gathers them; the records then move by the order
    wide = widen(replicated(keys))
    # 1. sampling: TotalOrderPartitioner split points
    sample = torch.sort(wide[:: max(n // 4096, 1)]).values
    splits = sample[:: max(sample.shape[0] // NUM_PARTS, 1)][:NUM_PARTS - 1]
    splits = splits.contiguous()

    # 2. shuffle: partition id per record + per-partition counts
    part = torch.searchsorted(splits, wide)
    if is_dtensor(part):  # each rank's counts, all-reduced
        counts = spmd_bincount(part, NUM_PARTS).to(torch.int32)
    else:
        counts = torch.bincount(part, minlength=NUM_PARTS).to(torch.int32)
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts

    # 3. sort + merge: global order carrying the 100-byte records
    order = torch.argsort(wide, stable=True)
    return take(keys, order), take(payload, order), offsets


HINTS = (
    MotifHint("sort", "quick", 0.70),
    MotifHint("sampling", "interval", 0.10),
    MotifHint("graph", "construct", 0.20),
)

TERASORT = register_workload(Workload(
    name="terasort",
    make_inputs=make_inputs,
    step=step,
    hints=HINTS,
    input_axes=("batch", "batch"),
))
