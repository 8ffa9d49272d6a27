"""Hopper-kernel lowerings of the motif hot loops (``substrate="hopper"``),
the port of ``repro/core/motifs/kernel_lowerings.py``.

Each lowering swaps exactly one variant's hot loop onto
``repro_torch.kernels.ops``; everything around it (chunk layout,
rank-merge rounds, argmin/normalize epilogues) is shared with the stock
form, so the two substrates agree against the ``kernels/ref.py`` plain
versions.  A lowering returns ``None`` for the variants it declines —
the same ones the reference declines — and ``Motif.execute`` then runs
the stock ``apply``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.core.motifs.base import (
    Motif,
    PVector,
    chunked,
    register_lowering,
)
from repro_torch.core.motifs.matrix import chunk_rows
from repro_torch.core.motifs.sort import merge_rounds
from repro_torch.distributed.spmd import is_dtensor, rows_op
from repro_torch.kernels import ops
from repro_torch.kernels.bitonic_sort import SENTINELS
from repro_torch.uint32 import full, take, widen


def _pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (bitonic networks need pow2 runs)."""
    return 1 << max(math.ceil(math.log2(max(int(n), 1))), 0)


# ---------------------------------------------------------------------------
# Sort: bitonic kernel runs + rank-merge rounds
# ---------------------------------------------------------------------------


@register_lowering("sort")
def sort_hopper(motif: Motif, p: PVector, inputs: Dict[str, Any],
                variant: str) -> Optional[Any]:
    keys = inputs["keys"]

    if variant == "quick":
        # the key ordering runs through the kernel path (bitonic runs +
        # rank merges); the payload keeps the record semantics through a
        # stable argsort and a gather
        order = torch.argsort(widen(keys), stable=True)
        blk = int(max(min(p.chunk_size, 4096), 2))
        return {"keys": ops.sort(keys, block=blk),
                "payload": take(inputs["payload"], order)}

    if variant == "merge":
        # map-side chunk sort on the bitonic kernel: pad every run to a
        # power of two with +max sentinels, sort all runs in one call,
        # slice the sentinels back off (they sort to each run's tail),
        # then the shared reduce-side rank-merge rounds
        kc = chunked(p, keys)           # (tasks, per, chunk)
        tasks, per, chunk = kc.shape
        runs = kc.reshape(tasks * per, chunk)
        blk = _pow2_ceil(chunk)
        if blk != chunk:
            pad = full((runs.shape[0], blk - chunk),
                       SENTINELS[runs.dtype], runs.dtype,
                       runs.device)
            runs = torch.cat([runs, pad], 1)
        flat = ops.bitonic_sort_blocks(runs.reshape(-1), block=blk)
        runs = flat.reshape(tasks * per, blk)[:, :chunk]
        return {"keys": merge_rounds(runs)}

    return None  # minmax: a pure reduction, no kernel — stock form


# ---------------------------------------------------------------------------
# Matrix: tiled matmul kernel under the chunk/task layout
# ---------------------------------------------------------------------------


@register_lowering("matrix")
def matrix_hopper(motif: Motif, p: PVector, inputs: Dict[str, Any],
                  variant: str) -> Optional[Any]:
    x, c, w = inputs["x"], inputs["centroids"], inputs["w"]

    if variant == "euclidean":
        # one kernel launch per execution, on every chunk row at once
        rows = chunk_rows(p, x)
        c2 = torch.sum(c * c, dim=-1)
        x2 = torch.sum(rows * rows, dim=-1, keepdim=True)
        d = x2 - 2.0 * ops.matmul(rows, c.T.contiguous()) + c2[None, :]
        return {"assign": torch.argmin(d, dim=-1).to(torch.int32),
                "dist": torch.amin(d, dim=-1)}

    if variant == "cosine":
        xn = x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-6)
        cn = c / (torch.linalg.norm(c, dim=-1, keepdim=True) + 1e-6)
        sim = ops.matmul(xn, cn.T.contiguous())
        return {"assign": torch.argmax(sim, dim=-1).to(torch.int32),
                "sim_max": torch.amax(sim, dim=-1)}

    if variant == "matmul":
        return {"y": ops.matmul(chunk_rows(p, x), w)}

    if variant == "fully_connected":
        b = torch.zeros((w.shape[-1],), dtype=x.dtype, device=x.device)
        return {"y": torch.relu(ops.matmul(chunk_rows(p, x), w) + b)}

    return None  # construct: normalization only, no matmul — stock form


# ---------------------------------------------------------------------------
# Statistics: row-moments reduction kernel
# ---------------------------------------------------------------------------


@register_lowering("statistics")
def statistics_hopper(motif: Motif, p: PVector, inputs: Dict[str, Any],
                      variant: str) -> Optional[Any]:
    if variant == "average":
        # same row set as the stock form (chunked() truncation included),
        # reduced per feature dim over the transposed (dim, rows) layout
        rows = chunk_rows(p, inputs["x"])
        mean, msq = ops.row_moments(rows.T.contiguous())
        return {"mean": mean, "var": msq - torch.square(mean)}

    if variant == "batchnorm":
        img = inputs["images"]
        ch_axis = img.ndim - 1 if p.layout == "NHWC" else 1
        xt = torch.movedim(img, ch_axis, 0)
        if is_dtensor(xt):  # each rank's kernel on its own images
            mean, msq = rows_op(ops.row_moments, xt)
        else:
            mean, msq = ops.row_moments(
                xt.reshape(xt.shape[0], -1).contiguous())
        var = msq - torch.square(mean)
        bshape = [1] * img.ndim
        bshape[ch_axis] = img.shape[ch_axis]
        return {"y": ((img - mean.reshape(bshape))
                      * torch.rsqrt(var.reshape(bshape) + 1e-5))}

    return None  # count/degree (segment sums) and softmax: stock form
