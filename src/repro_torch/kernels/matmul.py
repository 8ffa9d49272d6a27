"""Matrix product — the Matrix motif's hot loop on the GPU.

Wraps ``csrc/matmul.cu`` (which replaces the Pallas kernel in
``repro/kernels/matmul.py``) as the op ``repro_torch::matmul``, so a
signature profile sees one dot-class op with 2·M·N·K flops.  A tensor on
the CPU runs the plain version (``ref.matmul``); a CUDA tensor launches
the kernel or raises.  :func:`form` names the kernel's form (the narrow
one-pass form at small N; the split form, K cut into slices summed by a
thread block cluster, at few rows and long K; the wide FMA tile loop
otherwise; the kernel picks its own tile and load widths) and
``matmul.forms`` counts launches per form.  Under ``torch.func.vmap`` the
op's batching rule runs all lanes in one launch: lanes of x alone fold
into M, unless a lane takes the split form, lanes of y take the kernel's
lane axis (:func:`matmul_lanes`).
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
#: the split form's rows at most, its tile, the least K a slice sums, the
#: blocks it aims for (three for each of an H100's 132 SMs), and the most
#: slices (the portable cluster size).  Mirrored in ``csrc/matmul.cu``'s
#: ``split``.
SPLIT_MAX_M = 128
SPLIT_TILE = (32, 64)
SPLIT_MIN_K = 256
SPLIT_BLOCKS = 3 * 132
SPLIT_MAX_SLICES = 8
FORMS = ("narrow", "wide", "split")
#: the C launch's form codes: 0 picks from M, N and K as :func:`form` does
FORM_CODES = {"auto": 0, "wide": 1, "narrow": 2, "split": 3}


def split_slices(m: int, n: int, k: int) -> int:
    """The slices of K the split form cuts (M, N, K) into: about
    ``SPLIT_BLOCKS`` blocks over its tiles, at most ``SPLIT_MAX_SLICES``,
    none shorter than ``SPLIT_MIN_K``; 1 is no split."""
    bm, bn = SPLIT_TILE
    tiles = -(-m // bm) * -(-n // bn)
    return max(1, min(SPLIT_BLOCKS // tiles, SPLIT_MAX_SLICES,
                      k // SPLIT_MIN_K))


def form(x: torch.Tensor, y: torch.Tensor) -> str:
    """The kernel form a CUDA call on x (M, K) @ y (K, N) runs: "narrow"
    (one pass over x, whose rows must lie on the 16-byte grid), "split"
    (few rows, K cut into at least two slices) or "wide" (the FMA tile
    loop)."""
    (m, k), n = x.shape, y.shape[1]
    rows = x.data_ptr() % 16 == 0 and (k * x.element_size()) % 16 == 0
    narrow = n <= NARROW_SMALL_M_N or (n <= NARROW_N and m >= NARROW_FULL_M)
    if rows and narrow:
        return "narrow"
    return "split" if m <= SPLIT_MAX_M and split_slices(m, n, k) > 1 \
        else "wide"


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    """x (M, K) or (L, M, K) and y (K, N) or (L, K, N), contiguous, of
    one dtype and device; two lane operands have the same lane count."""
    if (x.ndim not in (2, 3) or y.ndim not in (2, 3)
            or x.shape[-1] != y.shape[-2]):
        raise ValueError(f"matmul wants (M,K) @ (K,N), got {tuple(x.shape)} "
                         f"@ {tuple(y.shape)}")
    if x.ndim == 3 and y.ndim == 3 and x.shape[0] != y.shape[0]:
        raise ValueError(f"matmul lanes: x has {x.shape[0]} lanes, y "
                         f"{y.shape[0]}")
    if x.dtype != y.dtype or x.dtype not in DTYPES:
        raise TypeError(f"matmul wants two f32 or two bf16 operands, got "
                        f"{x.dtype} and {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"operands on {x.device} and {y.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("matmul wants contiguous operands")


def _lane(t: torch.Tensor) -> torch.Tensor:
    """One lane of a lane operand, or the shared 2-D operand itself."""
    return t if t.ndim == 2 else t[0]


def launch_matmul(x: torch.Tensor, y: torch.Tensor,
                  kind: str = "auto") -> torch.Tensor:
    """The kernel on CUDA tensors x (M, K) or (L, M, K) and y (K, N) or
    (L, K, N) in form ``kind`` ("auto" picks as :func:`form` says;
    "narrow" takes N <= ``NARROW_N`` and x's rows on the 16-byte grid
    only; "split" cuts K into :func:`split_slices` slices).  A 2-D operand is shared by every lane; the kernel's lane axis
    (``blockIdx.z``) runs each lane with the tile, form and k order of a
    one-lane launch.  Returns (M, N), or (L, M, N) when an operand has
    lanes."""
    (M, K), N = _lane(x).shape, y.shape[-1]
    lanes = x.shape[0] if x.ndim == 3 else (y.shape[0] if y.ndim == 3 else 1)
    out = torch.empty((lanes, M, N), dtype=x.dtype, device=x.device)
    if out.numel():
        _build.call("repro_matmul_lanes", _build.dtype_code(x, DTYPES),
                    FORM_CODES[kind], x.data_ptr(), y.data_ptr(),
                    out.data_ptr(), M, N, K, lanes,
                    M * K if x.ndim == 3 else 0, K * N if y.ndim == 3 else 0,
                    M * N, _build.stream_ptr(x.device))
    return out if x.ndim == 3 or y.ndim == 3 else out[0]


def matmul_lanes(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x @ y in one launch, x (M, K) or (L, M, K), y (K, N) or (L, K, N),
    a 2-D operand shared by every lane (:func:`launch_matmul`).  The one
    wrapper of the kernel: the op and its batching rule both call it.  On
    the CPU, ``ref.matmul``."""
    _check(x, y)
    if x.device.type == "cpu":
        return ref.matmul(x, y)
    out = launch_matmul(x, y)
    if out.numel():
        _build.count_launch(matmul, form(_lane(x), _lane(y)))
    return out


def _matmul_op(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if x.ndim != 2 or y.ndim != 2:
        raise ValueError(f"matmul wants (M,K) @ (K,N), got {tuple(x.shape)} "
                         f"@ {tuple(y.shape)}")
    return matmul_lanes(x, y)


_build.define_op("matmul(Tensor x, Tensor y) -> Tensor", _matmul_op,
                 meta=lambda x, y: x.new_empty((x.shape[0], y.shape[1])))


def folds(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether lanes of x (L, M, K) alone fold into M against y (K, N):
    so where a lane runs the narrow or the wide form, which sum each
    output in k order whatever M is; a lane on the split form, whose
    slices follow M, takes the kernel's lane axis, so that it keeps its
    own launch's bits."""
    return form(x[0], y) != "split"


def _matmul_vmap(info, in_dims, x, y):
    """vmap of the op: lanes of x alone fold into M (one product) where
    :func:`folds` says so; other lanes take the kernel's lane axis
    (:func:`matmul_lanes`)."""
    dx, dy = in_dims
    if dx is not None:
        x = x.movedim(dx, 0)
    if dy is None:
        x = x.contiguous()
        if folds(x, y):
            lanes, M, K = x.shape
            out = torch.ops.repro_torch.matmul(x.reshape(lanes * M, K), y)
            return out.reshape(lanes, M, -1), 0
        return matmul_lanes(x, y.contiguous()), 0
    return matmul_lanes(x.contiguous(), y.movedim(dy, 0).contiguous()), 0


_build.define_vmap("matmul", _matmul_vmap)


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ y (K, N) with f32 accumulation, cast to x's dtype."""
    return torch.ops.repro_torch.matmul(x, y)


matmul.launches = 0
matmul.forms = dict.fromkeys(FORMS, 0)
