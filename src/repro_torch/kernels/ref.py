"""Plain PyTorch versions of the hand-written kernels (port of
``repro/kernels/ref.py``): the oracles the kernels are held against, and
what a kernel wrapper runs for a tensor on the CPU."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.uint32 import full, narrow, widen


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x @ y computed in f32, cast to x's dtype."""
    return torch.matmul(x.to(torch.float32), y.to(torch.float32)).to(x.dtype)


def row_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (mean, mean-of-squares) over the last dim, f32."""
    xf = x.to(torch.float32)
    return torch.mean(xf, dim=-1), torch.mean(xf * xf, dim=-1)


def sort(x: torch.Tensor) -> torch.Tensor:
    return narrow(torch.sort(widen(x)).values, x.dtype)


def sort_blocks(x: torch.Tensor, block: int, sentinel) -> torch.Tensor:
    """Each ``block``-sized run of 1-D ``x`` sorted, padded with
    ``sentinel`` up to a whole number of blocks (the output of
    ``bitonic_sort_blocks``)."""
    n = x.shape[0]
    pad = (-n) % block
    if pad:
        x = torch.cat([x, full((pad,), sentinel, x.dtype, x.device)])
    runs = torch.sort(widen(x).reshape(-1, block), dim=-1).values
    return narrow(runs.reshape(-1), x.dtype)
