"""The least work of the kernels the proxies run, from their shapes, and
the chip's peaks (``peaks.json``).

Each count reads every input byte once and writes every output byte once,
whatever the kernel reads again; a product counts 2 operations a
multiply-add.  A kernel's least time is the larger of its operations at
the peak rate and its bytes at the memory's rate.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, NamedTuple

PEAKS: Dict[str, float] = {
    k: float(v) for k, v in json.loads(
        (Path(__file__).resolve().parent / "peaks.json").read_text()).items()
    if k != "source"}


class Work(NamedTuple):
    ops: float
    nbytes: float
    peak_ops: float

    def bound_s(self) -> float:
        """The least time the chip could take."""
        return max(self.ops / self.peak_ops,
                   self.nbytes / PEAKS["hbm_bytes_per_s"])

    def bound_by(self) -> str:
        return ("operations" if self.ops / self.peak_ops
                > self.nbytes / PEAKS["hbm_bytes_per_s"] else "bytes")


def matmul(m: int, k: int, n: int, itemsize: int = 4,
           peak: str = "float32_flops_per_s") -> Work:
    """``x(m, k) @ y(k, n)``."""
    return Work(2.0 * m * n * k, float((m * k + k * n + m * n) * itemsize),
                PEAKS[peak])


def bmm(b: int, m: int, k: int, n: int, itemsize: int = 4,
        peak: str = "float32_flops_per_s") -> Work:
    one = matmul(m, k, n, itemsize, peak)
    return Work(b * one.ops, b * one.nbytes, one.peak_ops)


def row_moments(rows: int, d: int, itemsize: int = 4) -> Work:
    """Per-row f32 (mean, mean of squares) of a ``(rows, d)`` input."""
    return Work(2.0 * rows * d, float(rows * d * itemsize + 2 * rows * 4),
                PEAKS["float32_flops_per_s"])


def sort_blocks(n: int, block: int, itemsize: int = 4) -> Work:
    """Sorting each ``block`` of ``n`` keys: about log2(block) compares a
    key, the function's work and not the bitonic network's; the runs are
    written padded to whole blocks."""
    padded = n + (-n) % block
    return Work(float(n) * math.log2(block), float((n + padded) * itemsize),
                PEAKS["float32_flops_per_s"])
