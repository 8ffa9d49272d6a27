"""MoE dispatch — the capacity-bounded one-hot contraction on the GPU.

Wraps ``csrc/moe_dispatch.cu`` (which replaces ``moe_dispatch`` ->
``_dispatch_kernel`` in ``repro/kernels/moe_dispatch.py``) as the custom
op ``repro_torch::moe_dispatch``, so a signature profile sees one
dot-class op with 2·T·E·C·D flops.  As in the reference the mask is cast
to x's dtype before the product.  A tensor on the CPU runs the plain
version (``ref.moe_dispatch``); a CUDA tensor launches the kernel or
raises.  :func:`form` names the kernel's form (tensor cores for bf16 x,
full-f32 FMA with 8 x 8 register tiles for f32 x; the kernel picks its
own load widths) and
``moe_dispatch.forms`` counts launches per form.  :func:`make_dispatch_mask` is plain torch, as
in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_EXPERTS = 65535  # the grid's third dimension
FORMS = ("wgmma", "simt")
#: capacity rows of a block in each form; the grid's second dimension
#: counts them (D tiles are its first)
BM = {"wgmma": 128, "simt": 256}
MAX_GRID_Y = 65535


def form(x: torch.Tensor) -> str:
    """The kernel form a CUDA call on x runs: "wgmma" (bf16 x, tensor
    cores) or "simt" (f32 x, full-f32 FMA)."""
    return "wgmma" if x.dtype == torch.bfloat16 else "simt"


def _check(mask: torch.Tensor, x: torch.Tensor) -> None:
    if mask.ndim != 3 or x.ndim != 2 or mask.shape[0] != x.shape[0]:
        raise ValueError(f"moe_dispatch wants mask (T,E,C) and x (T,D), got "
                         f"{tuple(mask.shape)} and {tuple(x.shape)}")
    if mask.dtype not in DTYPES or x.dtype not in DTYPES:
        raise TypeError(f"moe_dispatch wants f32 or bf16, got {mask.dtype} "
                        f"and {x.dtype}")
    if mask.device != x.device:
        raise ValueError(f"operands on {mask.device} and {x.device}")
    if not (mask.is_contiguous() and x.is_contiguous()):
        raise ValueError("moe_dispatch wants contiguous operands")


def _moe_dispatch_op(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    _check(mask, x)
    if x.device.type == "cpu":
        return ref.moe_dispatch(mask.to(x.dtype), x)
    t, e, c = mask.shape
    d = x.shape[1]
    out = torch.empty((e, c, d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if e > MAX_EXPERTS:
        raise ValueError(f"moe_dispatch takes at most {MAX_EXPERTS} experts")
    kind = form(x)
    if -(-c // BM[kind]) > MAX_GRID_Y:
        raise ValueError(f"moe_dispatch: capacity {c} exceeds the launch "
                         f"grid")
    _build.call("repro_moe_dispatch", _build.dtype_code(mask, DTYPES),
                _build.dtype_code(x, DTYPES), mask.data_ptr(), x.data_ptr(),
                out.data_ptr(), t, e, c, d, _build.stream_ptr(x.device))
    _build.count_launch(moe_dispatch, kind)
    return out


_build.define_op(
    "moe_dispatch(Tensor mask, Tensor x) -> Tensor",
    _moe_dispatch_op)


def moe_dispatch(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """mask (T, E, C), x (T, D) -> expert buckets (E, C, D):
    ``out[e] = mask[:, e, :]ᵀ @ x`` with f32 accumulation, in x's dtype."""
    return torch.ops.repro_torch.moe_dispatch(mask, x)


moe_dispatch.launches = 0
moe_dispatch.forms = dict.fromkeys(FORMS, 0)


def make_dispatch_mask(expert_ids: torch.Tensor, num_experts: int,
                       capacity: int) -> torch.Tensor:
    """Top-1 routing decisions -> capacity-bounded one-hot dispatch mask
    (T, E, C), f32.

    The position of token t in its expert's bucket is the number of
    earlier tokens with the same expert; tokens past capacity are dropped
    (an all-zero row).  One-hot rows are comparisons against an arange,
    so an id outside ``[0, num_experts)`` gives a zero row, as
    ``jax.nn.one_hot`` does."""
    dev = expert_ids.device
    experts = torch.arange(num_experts, device=dev)
    onehot_e = (expert_ids[:, None] == experts[None, :]).to(torch.int32)
    pos = torch.cumsum(onehot_e, dim=0, dtype=torch.int32) - onehot_e
    slot = torch.sum(pos * onehot_e, dim=-1)
    slot = torch.where(slot < capacity, slot,
                       torch.full_like(slot, capacity))
    slots = torch.arange(capacity + 1, device=dev)
    onehot_c = (slot[:, None] == slots[None, :]).to(torch.float32)
    return (onehot_e.to(torch.float32)[:, :, None]
            * onehot_c[:, None, :capacity])
