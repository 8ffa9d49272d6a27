"""Matrix product — the Matrix motif's hot loop on the GPU.

Wraps ``csrc/matmul.cu`` (which replaces the Pallas kernel in
``repro/kernels/matmul.py``) as the op ``repro_torch::matmul``, so a
signature profile sees one dot-class op with 2·M·N·K flops.  A tensor on
the CPU runs the plain version (``ref.matmul``); a CUDA tensor launches
the kernel or raises.  :func:`form` names the kernel's form (the narrow
one-pass form at small N, the wide FMA tile loop above; the kernel picks
its own tile and load widths) and ``matmul.forms`` counts launches per
form.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

DTYPES = (torch.float32, torch.bfloat16)
#: widest N the narrow form takes, from ``NARROW_FULL_M`` rows on (a
#: block of 256 rows for each of an H100's 132 SMs); below that it takes
#: N up to ``NARROW_SMALL_M_N``.  Mirrored in ``csrc/matmul.cu``.
NARROW_N = 32
NARROW_FULL_M = 256 * 132
NARROW_SMALL_M_N = 16
FORMS = ("narrow", "wide")
#: the C launch's form codes: 0 picks from M and N as :func:`form` does
FORM_CODES = {"auto": 0, "wide": 1, "narrow": 2}


def form(x: torch.Tensor, y: torch.Tensor) -> str:
    """The kernel form a CUDA call on x (M, K) @ y (K, N) runs: "narrow"
    (one pass over x, whose rows must lie on the 16-byte grid) or "wide"
    (the FMA tile loop)."""
    (m, k), n = x.shape, y.shape[1]
    rows = x.data_ptr() % 16 == 0 and (k * x.element_size()) % 16 == 0
    narrow = n <= NARROW_SMALL_M_N or (n <= NARROW_N and m >= NARROW_FULL_M)
    return "narrow" if rows and narrow else "wide"


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


def launch_matmul(x: torch.Tensor, y: torch.Tensor,
                  kind: str = "auto") -> torch.Tensor:
    """The kernel on CUDA tensors x, y in form ``kind`` ("auto" picks as
    :func:`form` says; "narrow" takes N <= ``NARROW_N`` and x's rows on
    the 16-byte grid only)."""
    M, K = x.shape
    N = y.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if out.numel():
        _build.call("repro_matmul", _build.dtype_code(x, DTYPES),
                    FORM_CODES[kind], x.data_ptr(), y.data_ptr(),
                    out.data_ptr(), M, N, K, _build.stream_ptr(x.device))
    return out


def _matmul_op(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    _check(x, y)
    if x.device.type == "cpu":
        return ref.matmul(x, y)
    out = launch_matmul(x, y)
    if out.numel():
        matmul.launches += 1
        matmul.forms[form(x, y)] += 1
    return out


_build.define_op("matmul(Tensor x, Tensor y) -> Tensor", _matmul_op)


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ y (K, N) with f32 accumulation, cast to x's dtype."""
    return torch.ops.repro_torch.matmul(x, y)


matmul.launches = 0
matmul.forms = dict.fromkeys(FORMS, 0)
