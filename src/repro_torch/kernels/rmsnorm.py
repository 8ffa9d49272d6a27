"""Row moments — the Statistics motif's hot loop on the GPU.

Wraps ``csrc/row_moments.cu`` (which replaces ``row_moments`` ->
``_moments_kernel`` in ``repro/kernels/rmsnorm.py``) as the custom op
``repro_torch::row_moments``, so a signature profile sees one
reduce-class op.  A tensor on the CPU runs the plain version
(``ref.row_moments``); a CUDA tensor launches the kernel or raises.

The reference's fused ``rmsnorm`` kernel in the same file is not on the
``generate_proxy`` path and is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, ref

DTYPES = (torch.float32, torch.bfloat16)

#: pass-1 blocks the split-row design aims for (8 per SM of an H100)
TARGET_BLOCKS = 132 * 8
#: fewest elements a pass-1 block reduces
MIN_SEGMENT = 4096
MAX_SPLITS = 65535


def splits_for(rows: int, d: int) -> int:
    """How many segments each row is cut into: enough blocks to fill the
    card, never segments shorter than ``MIN_SEGMENT``."""
    want = -(-TARGET_BLOCKS // max(rows, 1))
    most = max(-(-d // MIN_SEGMENT), 1)
    return int(max(min(want, most, MAX_SPLITS), 1))


def _check(x: torch.Tensor) -> None:
    if x.ndim < 1 or x.shape[-1] == 0:
        raise ValueError(f"row_moments wants a non-empty last dim, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"row_moments wants f32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("row_moments wants a contiguous input")


@torch.library.custom_op("repro_torch::row_moments", mutates_args=())
def _row_moments_op(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(x)
    if x.device.type == "cpu":
        return ref.row_moments(x)
    if x.device.type != "cuda":
        raise ValueError(f"row_moments: unsupported device {x.device}")
    d = x.shape[-1]
    rows = x.numel() // d
    mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    msq = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    if rows == 0:
        return mean, msq
    splits = splits_for(rows, d)
    partial = torch.empty((rows, splits, 2), dtype=torch.float32,
                          device=x.device)
    _build.call("repro_row_moments", _build.dtype_code(x, DTYPES),
                x.data_ptr(), partial.data_ptr(), mean.data_ptr(),
                msq.data_ptr(), rows, d, splits,
                _build.stream_ptr(x.device))
    row_moments.launches += 1
    return mean, msq


def row_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row f32 ``(mean, mean of squares)`` over the last dim, shape
    ``x.shape[:-1]``; callers derive variance as ``msq - mean**2``."""
    return torch.ops.repro_torch.row_moments(x)


row_moments.launches = 0
