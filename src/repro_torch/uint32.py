"""uint32 keys where torch has no uint32 kernel.

Keys and payloads stay ``torch.uint32`` at every public surface, as in
the reference.  torch has few uint32 kernels: on the CPU (2.13) it lacks
``amin``/``amax``, ``searchsorted``, ``gather``, ``%`` and comparisons;
on CUDA (2.11) it lacks ``sort``/``argsort``, indexing, ``bitwise_xor``,
``amin`` and ``searchsorted`` as well (``chip_smoke.py`` prints what the
card supports).  So the ops that need one of those go through one of two
exact detours, taken for uint32 on every device:

* order-dependent ops (sort, argsort, searchsorted, min/max) run on an
  int64 copy (:func:`widen`), which holds the same order, and results
  come back through :func:`narrow`;
* bit-exact ops (indexing, XOR, fill) run on the same bits viewed as
  int32 (:func:`bits`), a free reinterpretation.

Under ``torch.func.vmap`` a lane tensor takes the wrapping conversion in
place of the view (:func:`reinterpret`): torch 2.11 has no batching rule
for a dtype view, and the conversion gives the same bits.
"""
from __future__ import annotations

import torch

_U32 = torch.uint32


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in a dtype with ordered kernels: uint32 becomes int64."""
    return x.to(torch.int64) if x.dtype == _U32 else x


def reinterpret(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The bits of ``x`` as ``dtype`` of the same width: a view, or for a
    lane tensor under ``torch.func.vmap`` the wrapping conversion, which
    gives the same bits (int32 and uint32 differ only in how they read
    them)."""
    if x.dtype == dtype:
        return x
    if torch._C._functorch.is_batchedtensor(x):
        return x.to(dtype)
    return x.view(dtype)


def narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Undo :func:`widen`: int64 values in [0, 2^32) back to ``dtype``."""
    if dtype != _U32:
        return x.to(dtype)
    signed = torch.where(x >= 1 << 31, x - (1 << 32), x)
    return reinterpret(signed.to(torch.int32), _U32)


def bits(x: torch.Tensor) -> torch.Tensor:
    """uint32 bits viewed as int32 (any other dtype unchanged)."""
    return reinterpret(x, torch.int32) if x.dtype == _U32 else x


def take(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` along the first dim, for any dtype.  A DTensor ``x``
    split on its rows, taken by a whole index, assembles the rows by a
    masked all-reduce (:func:`repro_torch.distributed.spmd.gather_rows`)."""
    if type(x).__name__ == "DTensor":
        from repro_torch.distributed.spmd import gather_rows

        out = gather_rows(bits(x), index)
        if out is not None:
            return reinterpret(out, x.dtype)
    return reinterpret(bits(x)[index], x.dtype)


def full(shape, value, dtype: torch.dtype,
         device: torch.device) -> torch.Tensor:
    """``torch.full`` for any dtype, uint32 filled through its int32 bits."""
    if dtype != _U32:
        return torch.full(shape, value, dtype=dtype, device=device)
    value = int(value)
    signed = value - (1 << 32) if value >= 1 << 31 else value
    return torch.full(shape, signed, dtype=torch.int32,
                      device=device).view(_U32)
