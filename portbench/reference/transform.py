"""Plain reference of the transform motif (3x3 convolutions of AlexNet
and Inception, the FFT).

Filters are HWIO and images NHWC or NCHW by ``p.layout``; the
convolution pads ``"SAME"`` (the odd pad below and right) and returns
the input's layout.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.arith import compute_dtype, conv2d_same
from portbench.reference.gen import generator, images, vectors

VARIANTS = ("conv2d", "fft", "conv2d_strided")
DEFAULT = "conv2d"
SIGNAL = 256


def out_channels(p) -> int:
    return max(p.channels, 4)


def signals(p) -> int:
    return max(int(p.data_size) // SIGNAL, 4)


def inputs(p, seed: int, device: torch.device) -> dict:
    gen = generator(seed, device)
    x = images(gen, p)
    filt = vectors(gen, 9 * p.channels, out_channels(p), p).reshape(
        3, 3, p.channels, out_channels(p))
    return {"x": x, "filt": filt, "signal": vectors(gen, signals(p), SIGNAL, p)}


def apply(p, inputs: dict, variant: str, precision: str):
    if variant == "fft":
        sig = inputs["signal"]
        freq = torch.fft.rfft(sig.to(compute_dtype(precision)), dim=-1)
        return {"power": (torch.abs(freq) ** 2).to(sig.dtype)}, {}
    x0 = inputs["x"]
    w = inputs["filt"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    x = x0.permute(0, 3, 1, 2) if p.layout == "NHWC" else x0
    y = conv2d_same(x, w, 2 if variant == "conv2d_strided" else 1, precision)
    if p.layout == "NHWC":
        y = y.permute(0, 2, 3, 1)
    return {"y": y.to(x0.dtype)}, {}


def flops(p, variant: str) -> float:
    """Arithmetic of one invocation: a multiply-add counts 2."""
    if variant == "fft":  # a real FFT of n points: 2.5 n log2 n; |.|^2: 3
        bins = SIGNAL // 2 + 1
        return signals(p) * (2.5 * SIGNAL * math.log2(SIGNAL) + 3.0 * bins)
    stride = 2 if variant == "conv2d_strided" else 1
    ho, wo = -(-p.height // stride), -(-p.width // stride)
    return (2.0 * max(p.batch_size, 1) * ho * wo * out_channels(p)
            * p.channels * 9)
