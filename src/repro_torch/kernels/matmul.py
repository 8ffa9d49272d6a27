"""Tiled matrix product — the Matrix motif's hot loop on the GPU.

Wraps ``csrc/matmul.cu`` (which replaces the Pallas kernel in
``repro/kernels/matmul.py``) as the custom op ``repro_torch::matmul``, so
a signature profile sees one dot-class op with 2·M·N·K flops.  A tensor
on the CPU runs the plain version (``ref.matmul``); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

DTYPES = (torch.float32, torch.bfloat16)


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul wants (M,K) @ (K,N), got {tuple(x.shape)} "
                         f"@ {tuple(y.shape)}")
    if x.dtype != y.dtype or x.dtype not in DTYPES:
        raise TypeError(f"matmul wants two f32 or two bf16 operands, got "
                        f"{x.dtype} and {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"operands on {x.device} and {y.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("matmul wants contiguous operands")


@torch.library.custom_op("repro_torch::matmul", mutates_args=())
def _matmul_op(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    _check(x, y)
    if x.device.type == "cpu":
        return ref.matmul(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"matmul: unsupported device {x.device}")
    M, K = x.shape
    N = y.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _build.call("repro_matmul", _build.dtype_code(x, DTYPES), x.data_ptr(),
                y.data_ptr(), out.data_ptr(), M, N, K,
                _build.stream_ptr(x.device))
    matmul.launches += 1
    return out


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ y (K, N) with f32 accumulation, cast to x's dtype."""
    return torch.ops.repro_torch.matmul(x, y)


matmul.launches = 0
