"""The precisions the reference computes in.

``float64`` is the reference itself: every arithmetic step of a motif in
double precision, its outputs rounded once to the dtype the proxy stores
them in.  ``tf32`` is the control, the step below the configurations'
stated precision (float32 with TF32 off): products and convolutions take
their operands rounded to TF32's 10-bit mantissa and accumulate in
float32, as the tensor cores do with TF32 on; all else is float32.  The
rounding is done here rather than by the library's TF32 switch, so the
control computes the same on every device.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Sequence

import torch
import torch.nn.functional as F

PRECISIONS = ("float64", "tf32")


def compute_dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """Library products and convolutions in full float32."""
    conv = torch.backends.cudnn.allow_tf32
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (ties to even)."""
    b = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return torch.where(b >= 1 << 31, b - (1 << 32), b).to(
        torch.int32).view(torch.float32)


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as a product's or convolution's operand."""
    x = x.to(compute_dtype(precision))
    return tf32_round(x) if precision == "tf32" else x


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    with exact_f32():
        return operand(a, precision) @ operand(b, precision)


def same_pads(size: int, window: int, stride: int) -> Sequence[int]:
    """(before, after) of one spatial dim under ``"SAME"`` padding:
    ``ceil(size / stride)`` outputs, the odd pad after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int,
                precision: str) -> torch.Tensor:
    """NCHW ``x`` by an OIHW filter ``w``, ``"SAME"`` padding."""
    top, bottom = same_pads(x.shape[2], w.shape[2], stride)
    left, right = same_pads(x.shape[3], w.shape[3], stride)
    x = F.pad(operand(x, precision), (left, right, top, bottom))
    with exact_f32():
        return F.conv2d(x, operand(w, precision), stride=stride)
