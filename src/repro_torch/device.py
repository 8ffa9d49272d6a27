"""Device resolution: CUDA unless the caller asks for the CPU.

The port's kernels exist for the GPU; a run that silently fell back to
the CPU would report CPU times under GPU metric names.  So ``None``
means ``cuda`` and a host without a CUDA device raises — the CPU is
used only when a caller (the tests) passes ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is ``cuda``.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """Run convolutions and f32 matrix products in full f32, whatever the
    caller's global flags say (cuDNN takes TF32 by default, and
    ``torch.set_float32_matmul_precision`` may allow it for products);
    the reference's are full f32.  The flags are restored on exit."""
    conv = torch.backends.cudnn.allow_tf32
    matmul = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.set_float32_matmul_precision(matmul)
