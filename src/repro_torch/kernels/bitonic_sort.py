"""Bitonic block sort — the Sort motif's hot loop on the GPU.

Wraps ``csrc/bitonic_sort.cu`` (which replaces ``bitonic_sort_blocks`` ->
``_sort_kernel`` -> ``_bitonic_block`` in ``repro/kernels/bitonic_sort.py``)
as the custom op ``repro_torch::bitonic_sort_blocks``, so a signature
profile sees one sort-class op.  A tensor on the CPU runs the plain
version (``ref.sort_blocks``); a CUDA tensor launches the kernel or
raises.

The pass order of the network lives here, in :func:`bitonic_schedule`,
so the CPU tests can replay it: tile passes sort inside each tile of
:func:`tile_for` keys (2048..32,768, several blocks to a tile when blocks
are smaller), and global passes take the strides of larger blocks that
cross tiles, up to ``GLOBAL_STRIDES`` of them in one read and write of
the array.  Under ``torch.func.vmap`` the op's batching rule sorts every
lane's blocks in one launch.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.uint32 import full

DTYPES = (torch.uint32, torch.int32, torch.float32, torch.bfloat16)

#: the +max padding of each dtype (sorts after every real key): integer
#: max for integer dtypes, +inf for floating ones
SENTINELS: Dict[torch.dtype, object] = {
    torch.uint32: (1 << 32) - 1, torch.int32: (1 << 31) - 1,
    torch.float32: float("inf"), torch.bfloat16: float("inf"),
}

#: most keys one thread block sorts in shared memory (128 KB of
#: four-byte keys), and fewest: smaller blocks share a tile
TILE = 1 << 15
MIN_TILE = 1 << 11
#: most strides one global pass takes (2**4 keys a thread)
GLOBAL_STRIDES = 4


def sort_sentinel(dtype: torch.dtype) -> torch.Tensor:
    """The +max padding scalar for ``dtype`` (sorts after every real key):
    integer max for integer dtypes, +inf for floating ones."""
    return torch.tensor(SENTINELS[dtype], dtype=dtype)


def effective_block(n: int, block: int) -> int:
    """The run length ``bitonic_sort_blocks`` actually sorts: the largest
    power of two <= min(block, n) (>= 2).  Callers that merge the returned
    runs must use this, not the requested ``block``."""
    return 1 << int(math.log2(max(min(block, n), 2)))


def tile_for(block: int) -> int:
    """Keys one thread block of the tile pass sorts for power-of-two
    ``block``: the block itself, within [MIN_TILE, TILE]."""
    return min(max(block, MIN_TILE), TILE)


Step = Tuple[int, ...]


def bitonic_schedule(block: int, tile: int) -> List[Tuple[str, Step]]:
    """The kernel's passes for power-of-two ``block`` and ``tile``.

    ``("tile", (k_lo, k_hi))``: stages k_lo..k_hi inside each tile, each
    stage from stride ``2**(min(k, log2 tile) - 1)`` down to 1.
    ``("global", (k, j_hi, j_lo))``: stage k's substeps of strides
    ``2**j_hi`` down to ``2**j_lo`` (>= tile, at most GLOBAL_STRIDES of
    them) over the whole array, in one pass."""
    b, t = int(math.log2(block)), int(math.log2(tile))
    steps: List[Tuple[str, Step]] = [("tile", (1, min(b, t)))]
    for k in range(t + 1, b + 1):
        for j_hi in range(k - 1, t - 1, -GLOBAL_STRIDES):
            steps.append(("global",
                          (k, j_hi, max(j_hi - GLOBAL_STRIDES + 1, t))))
        steps.append(("tile", (k, k)))
    return steps


@functools.lru_cache(maxsize=None)
def _plan(block: int) -> Tuple[int, int, Tuple[Tuple[str, Step], ...]]:
    """(log2 block, log2 tile, passes) for ``block``, built once."""
    tile = tile_for(block)
    return (block.bit_length() - 1, tile.bit_length() - 1,
            tuple(bitonic_schedule(block, tile)))


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


def _bitonic_sort_blocks_op(x: torch.Tensor, block: int) -> torch.Tensor:
    _check(x, block)
    if x.device.type == "cpu":
        return ref.sort_blocks(x, block, SENTINELS[x.dtype])
    n = x.shape[0]
    n_pad = n + (-n) % block
    out = torch.empty(n_pad, dtype=x.dtype, device=x.device)
    if n_pad == 0:
        return out
    code = _build.dtype_code(x, DTYPES)
    stream = _build.stream_ptr(x.device)
    log2_block, log2_tile, steps = _plan(block)
    src, n_src = x, n
    for kind, step in steps:
        if kind == "tile":
            _build.call("repro_bitonic_tile", code, src.data_ptr(),
                        out.data_ptr(), n_src, n_pad, log2_block, log2_tile,
                        *step, stream)
            src, n_src = out, n_pad
        else:
            _build.call("repro_bitonic_global", code, out.data_ptr(), n_pad,
                        log2_block, *step, stream)
    _build.count_launch(bitonic_sort_blocks)
    return out


_build.define_op(
    "bitonic_sort_blocks(Tensor x, SymInt block) -> Tensor",
    _bitonic_sort_blocks_op,
    meta=lambda x, block: x.new_empty((x.shape[0] + (-x.shape[0]) % block,)))


def _bitonic_sort_blocks_vmap(info, in_dims, x, block):
    """vmap of the op: the lanes' blocks are independent, so each lane is
    padded with the sentinel to whole blocks (what the op pads its output
    with) and (L, n) -> (L·n) sorts them all in one launch."""
    x = x.movedim(in_dims[0], 0)
    lanes, n = x.shape
    pad = (-n) % block
    if pad:
        x = torch.cat([x, full((lanes, pad), SENTINELS[x.dtype], x.dtype,
                               x.device)], 1)
    out = torch.ops.repro_torch.bitonic_sort_blocks(
        x.reshape(-1).contiguous(), block)
    return out.reshape(lanes, n + pad), 0


_build.define_vmap("bitonic_sort_blocks", _bitonic_sort_blocks_vmap)


def bitonic_sort_blocks(x: torch.Tensor, *, block: int = 1024) -> torch.Tensor:
    """Sort each ``block``-sized run of 1-D ``x``; the output is padded
    with ``sort_sentinel`` to a whole number of runs (callers slice or
    merge).  ``block`` is clamped by :func:`effective_block`."""
    return torch.ops.repro_torch.bitonic_sort_blocks(
        x, effective_block(x.shape[0], block))


bitonic_sort_blocks.launches = 0
