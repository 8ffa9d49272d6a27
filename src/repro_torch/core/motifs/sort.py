"""Sort motif — quick sort / merge sort / min-max calculation (port of
``repro/core/motifs/sort.py``).

The merge variant reproduces the paper's execution model explicitly:
per-task chunk sort ("map side") followed by log2(chunks) pairwise merges
("reduce side") built from searchsorted ranks.

Keys stay ``torch.uint32``; the sorts, searches, reductions and
gathers torch lacks for uint32 go through ``repro_torch.uint32``'s exact
detours, so every output keeps the key dtype.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.motifs.base import Motif, PVector, chunked, register
from repro_torch.data.generators import gen_text_records, make_generator
from repro_torch.device import resolve_device
from repro_torch.kernels.bitonic_sort import sort_sentinel
from repro_torch.uint32 import full, narrow, take, widen


def _take_rows(vals: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``vals[..., order]`` row by row, through a flat 1-D index (uint32
    has no gather kernel)."""
    width = vals.shape[-1]
    rows = vals.numel() // max(width, 1)
    offsets = (torch.arange(rows, device=vals.device) * width).reshape(
        order.shape[:-1] + (1,))
    return take(vals.reshape(-1), (order + offsets).reshape(-1)).reshape(
        order.shape)


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge sorted runs without scatter (rank-and-place), row-wise over
    any leading batch dims.

    Position of a[i] in the merged output = i + #(b < a[i]); a second
    searchsorted gives b's positions.  A stable argsort of the rank
    vector realises the permutation with gathers only."""
    wa, wb = widen(a).contiguous(), widen(b).contiguous()
    ra = (torch.arange(a.shape[-1], device=a.device)
          + torch.searchsorted(wb, wa, right=False))
    rb = (torch.arange(b.shape[-1], device=b.device)
          + torch.searchsorted(wa, wb, right=True))
    ranks = torch.cat([ra, rb], -1)
    vals = torch.cat([a, b], -1)
    order = torch.argsort(ranks, dim=-1, stable=True)
    return _take_rows(vals, order)


def merge_rounds(runs: torch.Tensor) -> torch.Tensor:
    """Reduce side of the merge sort: log2 pairwise rank-merge rounds over
    ``(n_runs, chunk)`` sorted runs, padding the run count to a power of
    two with the dtype's +max sentinel.  Shared by both substrates."""
    n, chunk = runs.shape
    pow2 = 1
    while pow2 < n:
        pow2 *= 2
    if pow2 != n:
        pad = full((pow2 - n, chunk), sort_sentinel(runs.dtype).item(),
                   runs.dtype, runs.device)
        runs = torch.cat([runs, pad], 0)
    while runs.shape[0] > 1:
        half = runs.shape[0] // 2
        runs = merge_sorted(runs[:half], runs[half:])
    return runs[0]


@register
class SortMotif(Motif):
    name = "sort"
    variants = ("quick", "merge", "minmax")
    default_variant = "quick"
    # `channels` doubles as the record payload width (words per key)
    tunable = ("data_size", "chunk_size", "num_tasks", "weight", "channels")

    def make_inputs(self, p: PVector, seed: int,
                    device: Optional[torch.device] = None) -> Dict[str, Any]:
        gen = make_generator(seed, resolve_device(device))
        keys, payload = gen_text_records(
            gen, int(p.data_size), payload_words=max(int(p.channels), 1),
            spec=p.spec())
        return {"keys": keys, "payload": payload}

    def apply(self, p: PVector, inputs: Dict[str, Any], variant: str = "") -> Any:
        v = self.resolve_variant(variant)
        keys = inputs["keys"]
        payload = inputs["payload"]

        if v == "quick":
            # full key+payload sort: the TeraSort record semantics (stable,
            # as jnp.argsort, so duplicated zipf keys keep payload order)
            order = torch.argsort(widen(keys), stable=True)
            return {"keys": take(keys, order), "payload": take(payload, order)}

        if v == "minmax":
            kc = widen(chunked(p, keys))  # (tasks, per, chunk)
            mins = torch.amin(kc, dim=-1)
            maxs = torch.amax(kc, dim=-1)
            return {"min": narrow(torch.amin(mins), keys.dtype),
                    "max": narrow(torch.amax(maxs), keys.dtype),
                    "task_min": narrow(torch.amin(mins, dim=-1), keys.dtype)}

        # merge sort: chunk-local sort, then log2 pairwise merge rounds
        kc = chunked(p, keys)           # (tasks, per, chunk)
        tasks, per, chunk = kc.shape
        runs = narrow(torch.sort(widen(kc.reshape(tasks * per, chunk)),
                                 dim=-1).values, keys.dtype)
        return {"keys": merge_rounds(runs)}
