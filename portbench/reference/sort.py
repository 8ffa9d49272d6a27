"""Plain reference of the sort motif (TeraSort's record sort, merge sort
over the paper's map and reduce sides, min-max).

Keys and payloads are uint32; every result is exact.  The merge sort's
reduce side pads its run count to a power of two with the largest key,
and those padding keys stay at the end of its output.
"""
from __future__ import annotations

import torch

from portbench.reference.gen import chunked, generator, records, u32_from_i64

VARIANTS = ("quick", "merge", "minmax")
DEFAULT = "quick"
SENTINEL = (1 << 32) - 1


def inputs(p, seed: int, device: torch.device) -> dict:
    gen = generator(seed, device)
    keys, payload = records(gen, int(p.data_size), max(int(p.channels), 1), p)
    return {"keys": keys, "payload": payload}


def _take(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)[index].view(x.dtype)


def apply(p, inputs: dict, variant: str, precision: str):
    keys = inputs["keys"]
    k = keys.to(torch.int64)
    if variant == "quick":  # stable, so equal keys keep payload order
        order = torch.sort(k, stable=True).indices
        return {"keys": _take(keys, order),
                "payload": _take(inputs["payload"], order)}, {}
    kc = chunked(k, p)  # (tasks, per, chunk)
    if variant == "minmax":
        mins, maxs = torch.amin(kc, -1), torch.amax(kc, -1)
        return {"min": u32_from_i64(torch.amin(mins)),
                "max": u32_from_i64(torch.amax(maxs)),
                "task_min": u32_from_i64(torch.amin(mins, -1))}, {}
    runs = kc.shape[0] * kc.shape[1]
    padded = 1 << max(runs - 1, 0).bit_length()
    merged = torch.sort(kc.reshape(-1)).values
    pad = torch.full(((padded - runs) * kc.shape[2],), SENTINEL,
                     dtype=torch.int64, device=k.device)
    return {"keys": u32_from_i64(torch.cat([merged, pad]))}, {}


def flops(p, variant: str) -> float:
    return 0.0  # comparisons and moves, no arithmetic
