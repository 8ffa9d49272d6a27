"""Row moments and fused RMSNorm — the Statistics hot loops on the GPU.

Wraps ``csrc/row_moments.cu`` (which replaces ``row_moments`` ->
``_moments_kernel`` in ``repro/kernels/rmsnorm.py``) as the custom op
``repro_torch::row_moments``, and ``csrc/rmsnorm.cu`` (which replaces
``rmsnorm`` -> ``_rmsnorm_kernel`` in the same file) as
``repro_torch::rmsnorm``, so a signature profile sees one reduce-class op
for each.  A tensor on the CPU runs the plain version (``ref``); a CUDA
tensor launches the kernel or raises.  Row moments has two forms, named
by :func:`form` and counted per form in ``row_moments.forms``: one launch
(small inputs, or rows enough to fill the card) and split rows (two
launches, for a few long rows).  RMSNorm has two, named by
:func:`rmsnorm_form` (also ``rmsnorm.form``) and counted in
``rmsnorm.forms``: ``warp`` (16-byte loads and stores, a part of a warp
or a warp a row) and ``scalar`` (rows off the 16-byte grid or longer
than the warp form takes).  Under ``torch.func.vmap`` row moments' batching
rule folds the lanes into rows: one launch for all lanes.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, ref

DTYPES = (torch.float32, torch.bfloat16)

#: pass-1 blocks the split form aims for: 4 blocks of 256 threads on
#: each SM of an H100, one wave with no tail of a second
TARGET_BLOCKS = 132 * 4
#: fewest elements a pass-1 block reduces
MIN_SEGMENT = 4096
MAX_SPLITS = 65535
#: one launch for inputs up to ONE_LAUNCH_BYTES and for rows up to
#: ONE_LAUNCH_ROW_BYTES: a block reads its row at ~85 GB/s, so such a row
#: costs the one-launch form about what a second launch and the scratch
#: buffer cost the host (~8 µs); measured by ``repro_torch.bench.
#: thresholds``, where below both bounds one launch was within 4 µs of
#: the split form's device time at every row count from 8 to 128
ONE_LAUNCH_BYTES = 4 << 20
ONE_LAUNCH_ROW_BYTES = 512 << 10


def fill_splits(rows: int, d: int) -> int:
    """The split form's segments a row: enough pass-1 blocks to fill the
    card in one wave, no segment shorter than ``MIN_SEGMENT``."""
    want = TARGET_BLOCKS // max(rows, 1)
    most = max(d // MIN_SEGMENT, 1)
    return int(max(min(want, most, MAX_SPLITS), 1))


def splits_for(rows: int, d: int, itemsize: int = 4) -> int:
    """How many segments each row is cut into: 1 (one launch) for inputs
    up to ``ONE_LAUNCH_BYTES``, rows up to ``ONE_LAUNCH_ROW_BYTES`` and
    rows enough to fill the card, else :func:`fill_splits`."""
    if (rows * d * itemsize <= ONE_LAUNCH_BYTES
            or d * itemsize <= ONE_LAUNCH_ROW_BYTES):
        return 1
    return fill_splits(rows, d)


FORMS = ("one_launch", "split")


def form(x: torch.Tensor) -> str:
    """The row-moments form a CUDA call on x runs."""
    d = max(x.shape[-1], 1)
    return ("one_launch" if splits_for(x.numel() // d, d, x.element_size())
            == 1 else "split")


def _check(x: torch.Tensor) -> None:
    if x.ndim < 1 or x.shape[-1] == 0:
        raise ValueError(f"row_moments wants a non-empty last dim, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"row_moments wants f32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("row_moments wants a contiguous input")


def launch_row_moments(x: torch.Tensor, splits: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensor x with ``splits`` segments a row (1: the
    one-launch form); :func:`splits_for` gives the op's choice."""
    d = x.shape[-1]
    rows = x.numel() // d
    mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    msq = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    if rows == 0:
        return mean, msq
    # the split form's per-segment sums; the one-launch form needs none
    partial = None if splits == 1 else torch.empty(
        (rows, splits, 2), dtype=torch.float32, device=x.device)
    _build.call("repro_row_moments", _build.dtype_code(x, DTYPES),
                x.data_ptr(), None if partial is None else partial.data_ptr(),
                mean.data_ptr(), msq.data_ptr(), rows, d, splits,
                _build.stream_ptr(x.device))
    return mean, msq


def _row_moments_op(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(x)
    if x.device.type == "cpu":
        return ref.row_moments(x)
    d = x.shape[-1]
    splits = splits_for(x.numel() // d, d, x.element_size())
    out = launch_row_moments(x, splits)
    if x.numel():
        _build.count_launch(row_moments, FORMS[splits > 1])
    return out


def _row_moments_meta(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return (x.new_empty(x.shape[:-1], dtype=torch.float32),
            x.new_empty(x.shape[:-1], dtype=torch.float32))


_build.define_op("row_moments(Tensor x) -> (Tensor, Tensor)", _row_moments_op,
                 meta=_row_moments_meta)


def _row_moments_vmap(info, in_dims, x):
    """vmap of the op: the lanes' rows are rows, (L, R, C) -> (L·R, C),
    one launch."""
    x = x.movedim(in_dims[0], 0)
    lead = x.shape[:-1]
    mean, msq = torch.ops.repro_torch.row_moments(
        x.reshape(-1, x.shape[-1]).contiguous())
    return (mean.reshape(lead), msq.reshape(lead)), (0, 0)


_build.define_vmap("row_moments", _row_moments_vmap)


def row_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row f32 ``(mean, mean of squares)`` over the last dim, shape
    ``x.shape[:-1]``; callers derive variance as ``msq - mean**2``."""
    return torch.ops.repro_torch.row_moments(x)


row_moments.launches = 0
row_moments.forms = dict.fromkeys(FORMS, 0)


def _check_rmsnorm(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim < 1 or x.shape[-1] == 0:
        raise ValueError(f"rmsnorm wants a non-empty last dim, got "
                         f"{tuple(x.shape)}")
    if w.ndim != 1 or w.shape[0] != x.shape[-1]:
        raise ValueError(f"rmsnorm wants w of shape ({x.shape[-1]},), got "
                         f"{tuple(w.shape)}")
    if x.dtype not in DTYPES or w.dtype not in DTYPES:
        raise TypeError(f"rmsnorm wants f32 or bf16, got {x.dtype} and "
                        f"{w.dtype}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm wants contiguous operands")


RMSNORM_FORMS = ("warp", "scalar")
#: longest row of the warp form, in 16-byte units (``csrc/rmsnorm.cu``)
WARP_UNITS = 32 * 12


def rmsnorm_form(x: torch.Tensor, w: torch.Tensor = None) -> str:
    """The RMSNorm form a CUDA call on x runs, by ``csrc/rmsnorm.cu``'s
    rule: rows whose bytes and base lie on the 16-byte grid, up to
    ``WARP_UNITS`` 16-byte units a row, take ``warp``; any other row
    ``scalar``.  The output is a fresh allocation, on the grid; w is read
    whatever its alignment."""
    d = x.shape[-1]
    unit = 16 // x.element_size()
    if d % unit or d // unit > WARP_UNITS or x.data_ptr() % 16:
        return "scalar"
    return "warp"


def _rmsnorm_op(x: torch.Tensor, w: torch.Tensor,
                eps: float) -> torch.Tensor:
    _check_rmsnorm(x, w)
    if x.device.type == "cpu":
        return ref.rmsnorm(x, w, eps)
    out = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d
    if rows == 0:
        return out
    _build.call("repro_rmsnorm", _build.dtype_code(x, DTYPES),
                _build.dtype_code(w, DTYPES), x.data_ptr(), w.data_ptr(),
                out.data_ptr(), rows, d, eps, _build.stream_ptr(x.device))
    _build.count_launch(rmsnorm, rmsnorm_form(x))
    return out


_build.define_op(
    "rmsnorm(Tensor x, Tensor w, float eps) -> Tensor",
    _rmsnorm_op)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """``x (..., D) · rsqrt(mean(x²) + eps) · w`` in f32, one read of x,
    cast to x's dtype."""
    return torch.ops.repro_torch.rmsnorm(x, w, eps)


rmsnorm.launches = 0
rmsnorm.forms = dict.fromkeys(RMSNORM_FORMS, 0)
rmsnorm.form = rmsnorm_form
