"""Bitonic block sort — the Sort motif's hot loop on the GPU.

Wraps ``csrc/bitonic_sort.cu`` (which replaces ``bitonic_sort_blocks`` ->
``_sort_kernel`` -> ``_bitonic_block`` in ``repro/kernels/bitonic_sort.py``)
as the custom op ``repro_torch::bitonic_sort_blocks``, so a signature
profile sees one sort-class op.  A tensor on the CPU runs the plain
version (``ref.sort_blocks``); a CUDA tensor launches the kernel or
raises.

The pass order of the network lives here, in :func:`bitonic_schedule`,
so the CPU tests can replay it: shared-memory tile passes for strides
below the tile, one global-memory pass per larger stride.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from repro_torch.kernels import _build, ref

DTYPES = (torch.uint32, torch.int32, torch.float32, torch.bfloat16)

#: keys one thread block sorts in shared memory (32 KB of four-byte keys)
TILE = 1 << 13


def sort_sentinel(dtype: torch.dtype) -> torch.Tensor:
    """The +max padding scalar for ``dtype`` (sorts after every real key):
    integer max for integer dtypes, +inf for floating ones."""
    fill = (float("inf") if dtype.is_floating_point
            else torch.iinfo(dtype).max)
    return torch.tensor(fill, dtype=dtype)


def effective_block(n: int, block: int) -> int:
    """The run length ``bitonic_sort_blocks`` actually sorts: the largest
    power of two <= min(block, n) (>= 2).  Callers that merge the returned
    runs must use this, not the requested ``block``."""
    return 1 << int(math.log2(max(min(block, n), 2)))


def bitonic_schedule(block: int, tile: int) -> List[Tuple[str, int, int]]:
    """The kernel's passes for power-of-two ``block`` and ``tile`` (<= block).

    ``("tile", k_lo, k_hi)``: stages k_lo..k_hi inside each tile, each
    stage from stride ``2**(min(k, log2 tile) - 1)`` down to 1.
    ``("global", k, j)``: stage k's substep of stride ``2**j`` (>= tile)
    over the whole array."""
    b, t = int(math.log2(block)), int(math.log2(tile))
    steps: List[Tuple[str, int, int]] = [("tile", 1, t)]
    for k in range(t + 1, b + 1):
        steps.extend(("global", k, j) for j in range(k - 1, t - 1, -1))
        steps.append(("tile", k, k))
    return steps


def _check(x: torch.Tensor, block: int) -> None:
    if x.ndim != 1:
        raise ValueError(f"bitonic_sort_blocks wants a 1-D tensor, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"bitonic_sort_blocks does not sort {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("bitonic_sort_blocks wants a contiguous input")
    if block < 2 or block & (block - 1):
        raise ValueError(f"block must be a power of two >= 2, got {block}")


@torch.library.custom_op("repro_torch::bitonic_sort_blocks", mutates_args=())
def _bitonic_sort_blocks_op(x: torch.Tensor, block: int) -> torch.Tensor:
    _check(x, block)
    sentinel = sort_sentinel(x.dtype).item()
    if x.device.type == "cpu":
        return ref.sort_blocks(x, block, sentinel)
    if x.device.type != "cuda":
        raise ValueError(f"bitonic_sort_blocks: unsupported device {x.device}")
    n = x.shape[0]
    n_pad = n + (-n) % block
    out = torch.empty(n_pad, dtype=x.dtype, device=x.device)
    if n_pad == 0:
        return out
    code = _build.dtype_code(x, DTYPES)
    stream = _build.stream_ptr(x.device)
    tile = min(block, TILE)
    log2_block, log2_tile = int(math.log2(block)), int(math.log2(tile))
    src, n_src = x, n
    for kind, a, b in bitonic_schedule(block, tile):
        if kind == "tile":
            _build.call("repro_bitonic_tile", code, src.data_ptr(),
                        out.data_ptr(), n_src, n_pad, log2_block, log2_tile,
                        a, b, stream)
            src, n_src = out, n_pad
        else:
            _build.call("repro_bitonic_global", code, out.data_ptr(), n_pad,
                        log2_block, a, b, stream)
    bitonic_sort_blocks.launches += 1
    return out


def bitonic_sort_blocks(x: torch.Tensor, *, block: int = 1024) -> torch.Tensor:
    """Sort each ``block``-sized run of 1-D ``x``; the output is padded
    with ``sort_sentinel`` to a whole number of runs (callers slice or
    merge).  ``block`` is clamped by :func:`effective_block`."""
    return torch.ops.repro_torch.bitonic_sort_blocks(
        x, effective_block(x.shape[0], block))


bitonic_sort_blocks.launches = 0
