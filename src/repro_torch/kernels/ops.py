"""Public wrappers for the hand-written kernels (port of
``repro/kernels/ops.py``) and their launch counters.

A tensor on the CPU runs each kernel's plain version; a CUDA tensor
launches the kernel or raises.  ``sort`` keeps the reference composition:
bitonic runs at the clamped block length, then rank-merge rounds that pad
an odd run count with the dtype's sentinel.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from repro_torch.kernels import bitonic_sort as _bs
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import rmsnorm as _rm
from repro_torch.uint32 import full

matmul = _mm.matmul
row_moments = _rm.row_moments
bitonic_sort_blocks = _bs.bitonic_sort_blocks


class Kernel(NamedTuple):
    """One hand-written kernel."""

    #: bumps ``wrapper.launches`` once per launch; named like its custom op
    wrapper: Callable
    #: the CUDA source, from the repo root
    source: str
    #: the reference's Pallas kernel it replaces, file:line
    replaces: str


KERNELS: Dict[str, Kernel] = {
    "matmul": Kernel(_mm.matmul, "src/repro_torch/kernels/csrc/matmul.cu",
                     "src/repro/kernels/matmul.py:46"),
    "row_moments": Kernel(_rm.row_moments,
                          "src/repro_torch/kernels/csrc/row_moments.cu",
                          "src/repro/kernels/rmsnorm.py:47"),
    "bitonic_sort": Kernel(_bs.bitonic_sort_blocks,
                           "src/repro_torch/kernels/csrc/bitonic_sort.cu",
                           "src/repro/kernels/bitonic_sort.py:74"),
}


def launch_counts() -> Dict[str, int]:
    return {name: k.wrapper.launches for name, k in KERNELS.items()}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.wrapper.launches = 0


def sort(x: torch.Tensor, *, block: int = 1024) -> torch.Tensor:
    """Full 1-D sort: kernel bitonic runs + rank-merge rounds."""
    from repro_torch.core.motifs.sort import merge_sorted

    n = x.shape[0]
    # merge at the run length the kernel actually sorted, never the
    # requested one
    blk = _bs.effective_block(n, block)
    runs = _bs.bitonic_sort_blocks(x, block=blk).reshape(-1, blk)
    while runs.shape[0] > 1:
        if runs.shape[0] % 2:
            pad = full((1, runs.shape[1]), _bs.sort_sentinel(x.dtype).item(),
                       x.dtype, x.device)
            runs = torch.cat([runs, pad], 0)
        half = runs.shape[0] // 2
        runs = merge_sorted(runs[:half], runs[half:])
    return runs[0][:n]
