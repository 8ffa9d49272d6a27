"""Transform motif — domain-conversion computations (port of
``repro/core/motifs/transform.py``).

Paper Table III implementations covered:
* ``conv2d`` / ``conv2d_strided``  (AlexNet / Inception convolutions)
* ``fft``                          (the paper's canonical transform example)

Filters are HWIO and images NHWC or NCHW by ``p.layout``, as in the
reference; the convolution runs on NCHW views with the filter as OIHW.
JAX's ``"SAME"`` padding is asymmetric at stride 2 (the extra row and
column go below and right), which torch's ``padding="same"`` refuses, so
the pads are computed per side (:func:`same_pads`) and applied first.
Convolutions run in full f32 (:func:`repro_torch.device.full_f32`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.motifs.base import Motif, PVector, register
from repro_torch.data.generators import gen_images, gen_vectors, make_generator
from repro_torch.distributed.spmd import (batch_conv, is_dtensor, local_op,
                                         replicate_dims)
from repro_torch.device import full_f32, resolve_device


def same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of one spatial dim under JAX's ``"SAME"``:
    ``ceil(size / stride)`` outputs, the odd pad after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, window: Sequence[int], stride: int,
             value: float = 0.0) -> torch.Tensor:
    """NCHW ``x`` padded for a ``"SAME"`` window of ``(kh, kw)``.  A
    DTensor ``x`` is padded shard by shard, its spatial dims whole."""
    top, bottom = same_pads(x.shape[2], window[0], stride)
    left, right = same_pads(x.shape[3], window[1], stride)
    if top == bottom == left == right == 0:
        return x
    if is_dtensor(x):
        return local_op(lambda t: F.pad(t, (left, right, top, bottom),
                                        value=value),
                        replicate_dims(x, (2, 3)))
    return F.pad(x, (left, right, top, bottom), value=value)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """NCHW ``x`` by an OIHW filter, ``"SAME"`` or ``"VALID"`` as in
    ``jax.lax.conv_general_dilated``.  Sharded (DTensor) operands run as
    :func:`repro_torch.distributed.spmd.batch_conv`: each rank convolves
    its batch shard with the whole filter."""
    if is_dtensor(x) or is_dtensor(w):
        return batch_conv(lambda a, b: conv2d(a, b, stride, padding), x, w)
    if padding == "SAME":
        x = pad_same(x, w.shape[2:], stride)
    with full_f32():
        return F.conv2d(x, w, stride=stride)


@register
class TransformMotif(Motif):
    name = "transform"
    variants = ("conv2d", "fft", "conv2d_strided")
    default_variant = "conv2d"
    tunable = ("data_size", "weight", "batch_size", "height", "width",
               "channels")
    data_kind = "images"

    def make_inputs(self, p: PVector, seed: int,
                    device: Optional[torch.device] = None) -> Dict[str, Any]:
        gen = make_generator(seed, resolve_device(device))
        x = gen_images(gen, max(p.batch_size, 1), p.height, p.width,
                       p.channels, p.layout, p.spec())
        cout = max(p.channels, 4)
        filt = gen_vectors(gen, 3 * 3 * p.channels, cout, p.spec()).reshape(
            3, 3, p.channels, cout)
        sig = gen_vectors(gen, max(int(p.data_size) // 256, 4), 256, p.spec())
        return {"x": x, "filt": filt, "signal": sig}

    def apply(self, p: PVector, inputs: Dict[str, Any], variant: str = "") -> Any:
        v = self.resolve_variant(variant)
        if v == "fft":
            sig = inputs["signal"]
            freq = torch.fft.rfft(sig.to(torch.float32), dim=-1)
            return {"power": (torch.abs(freq) ** 2).to(sig.dtype)}

        x = inputs["x"]
        w = inputs["filt"].to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
        if p.layout == "NHWC":
            x = x.permute(0, 3, 1, 2)
        y = conv2d(x, w, stride=2 if v == "conv2d_strided" else 1)
        return {"y": y.permute(0, 2, 3, 1) if p.layout == "NHWC" else y}
