"""FlashAttention-2 forward on the GPU.

Wraps ``csrc/flash_attention.cu`` (which replaces
``flash_attention_single`` -> ``_flash_kernel`` in
``repro/kernels/flash_attention.py``) as the custom op
``repro_torch::flash_attention`` on the ``(B, S, H, D)`` layout: one
launch covers every batch and head, where the reference vmaps its
single-slice kernel.  A signature profile sees one dot-class op with
4·D flops for every (query, key) pair the mask keeps.  A tensor on the
CPU runs the plain version (``ref.flash_attention``); a CUDA tensor
launches the kernel or raises.  :func:`form` names the kernel's form
(tensor cores for bf16, register-tiled FMA for f32, each at every head
width, compiled for the widths ``WGMMA_D`` with a narrower head
zero-padded to the next one up (:func:`padded_width`); the kernel picks
its own load widths) and ``flash_attention.forms`` counts launches per
form.

The causal mask keeps ``k_idx <= q_idx`` with both indices counted from
0, top-left aligned as in the reference, also when ``Sq != Skv``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build, ref

DTYPES = (torch.float32, torch.bfloat16)
#: the reference's masked score and the floor of the softmax denominator
#: (``flash_attention.py``), mirrored in ``csrc/flash_attention.cu``
NEG_INF = -1e30
L_FLOOR = 1e-30
#: widest head the kernel takes
MAX_D = 256
#: the widths the tensor-core form (bf16) and the tiled form (f32) are
#: compiled for
WGMMA_D = (64, 128, 192, 256)
TILED_D = WGMMA_D
FORMS = ("wgmma", "tiled")
#: query tile of each form; the grid's second dimension counts them
BQ = {"wgmma": 128, "tiled": 128}
MAX_GRID_Y = 65535
MAX_GRID_X = (1 << 31) - 1


def padded_width(d: int) -> int:
    """The compiled width a head of width d runs at, in either type:
    the narrowest one that holds it, the columns past d zero-filled."""
    if not 1 <= d <= MAX_D:
        raise ValueError(f"flash_attention takes head widths 1..{MAX_D}, "
                         f"got {d}")
    return next(w for w in WGMMA_D if w >= d)


def form(q: torch.Tensor) -> str:
    """The kernel form a CUDA call on q runs, at any head width:
    "wgmma" (bf16, tensor cores, 128 queries a block) or "tiled" (f32:
    FMA, 128 queries a block, 8 a thread in registers)."""
    return "wgmma" if q.dtype == torch.bfloat16 else "tiled"


def kept_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs the mask keeps in one head: all of them, or
    ``min(q + 1, Skv)`` for each query under the causal mask."""
    if not causal:
        return sq * skv
    full = max(min(sq, skv), 0)           # queries q < Skv keep q + 1 keys
    return full * (full + 1) // 2 + max(sq - skv, 0) * skv


def flops(q: torch.Tensor, k: torch.Tensor, causal: bool) -> float:
    """Flops of one call on the (B, S, H, D) layout: 2·D for q·k and 2·D
    for p·v per kept pair."""
    b, sq, h, d = q.shape
    return 4.0 * b * h * d * kept_pairs(sq, k.shape[1], causal)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention wants q (B,Sq,H,D), k and v "
                         f"(B,Skv,H,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch, heads or head width")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"flash_attention takes head widths 1..{MAX_D}, "
                         f"got {d}")
    if k.shape[1] == 0:
        raise ValueError("flash_attention wants at least one key")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"flash_attention wants three f32 or three bf16 "
                        f"operands, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention wants contiguous operands")


def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool) -> torch.Tensor:
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal)
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    kind = form(q)
    if -(-sq // BQ[kind]) > MAX_GRID_Y or b * h > MAX_GRID_X:
        raise ValueError(f"flash_attention: {tuple(q.shape)} exceeds the "
                         f"launch grid")
    _build.call("repro_flash_attention", _build.dtype_code(q, DTYPES),
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, sq, k.shape[1], h, d, 1.0 / math.sqrt(d), int(causal),
                _build.stream_ptr(q.device))
    _build.count_launch(flash_attention, kind)
    return out


_build.define_op(
    "flash_attention(Tensor q, Tensor k, Tensor v, bool causal) -> Tensor",
    _flash_attention_op)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention with scale ``1/sqrt(D)`` on ``(B, S, H, D)`` or
    ``(S, D)`` operands, f32 inside, cast to q's dtype."""
    single = q.ndim == 2
    if single:
        q, k, v = q[None, :, None], k[None, :, None], v[None, :, None]
    out = torch.ops.repro_torch.flash_attention(q, k, v, causal)
    return out[0, :, 0] if single else out


flash_attention.launches = 0
flash_attention.forms = dict.fromkeys(FORMS, 0)


def flash_attention_single(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *,
                           causal: bool = True) -> torch.Tensor:
    """q (Sq, D), k/v (Skv, D) -> out (Sq, D): one head, the reference's
    single-slice entry point."""
    if q.ndim != 2 or k.ndim != 2 or v.ndim != 2:
        raise ValueError(f"flash_attention_single wants (S, D) operands, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    return flash_attention(q, k, v, causal=causal)
