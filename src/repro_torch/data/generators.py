"""Input-data generators — the gensort / BDGS analogs (port of
``repro/data/generators.py``).

Each generator draws from an explicit ``torch.Generator`` and makes its
tensors on that generator's device, so a run is reproducible from one
seed.  The streams differ from ``jax.random``'s; only the distributions
are held against the reference.

``sparsity``, ``scale`` and ``zipf_alpha`` may be 0-d tensors as well as
Python floats (the evaluator's lifted knobs).  The rule is the
reference's: a Python ``0.0`` sparsity skips the mask and a Python
``1.0`` scale skips the multiply, while a tensor value always applies
them.  Masking with keep-probability 1.0 keeps every element because
``torch.rand`` draws from [0, 1), and multiplying by 1.0 is a bitwise
identity, so both forms give equal values.

Keys and payloads are ``torch.uint32``, as in the reference.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.uint32 import narrow


@dataclass(frozen=True)
class DataSpec:
    """Controlled data characteristics (paper §II-A: type/pattern/distribution).

    ``sparsity``, ``scale`` and ``zipf_alpha`` accept 0-d tensors as well
    as Python floats; ``distribution``/``dtype`` select code paths."""

    distribution: str = "uniform"   # uniform | normal | zipf
    sparsity: float = 0.0           # fraction of zeros (liftable)
    zipf_alpha: float = 1.2         # power-law exponent (liftable)
    dtype: str = "float32"
    scale: float = 1.0              # distribution scale parameter (liftable)


def derive_seed(*parts: int) -> int:
    """A 63-bit seed derived from integers (the ``fold_in`` analog)."""
    state = np.random.SeedSequence([int(p) for p in parts]).generate_state(
        1, np.uint64)[0]
    return int(state >> np.uint64(1))


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@functools.lru_cache(maxsize=64)
def zipf_probs(n: int, alpha: float = 1.2) -> np.ndarray:
    """Zipf pmf over n categories (host-side f64 reference, cached)."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return (p / p.sum()).astype(np.float32)


def _apply_sparsity(gen: torch.Generator, x: torch.Tensor,
                    sparsity) -> torch.Tensor:
    """Zero a ``sparsity`` fraction of ``x``; ``sparsity`` may be a tensor."""
    if isinstance(sparsity, (int, float)) and float(sparsity) <= 0.0:
        return x
    keep_p = 1.0 - torch.as_tensor(sparsity, dtype=torch.float32,
                                   device=x.device)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_p
    return torch.where(keep, x, torch.zeros_like(x))


def _apply_scale(x: torch.Tensor, scale) -> torch.Tensor:
    """Multiply float data by the distribution scale (tensor or float)."""
    if isinstance(scale, (int, float)) and float(scale) == 1.0:
        return x
    return x * torch.as_tensor(scale, device=x.device).to(x.dtype)


def _zipf_cdf(cats: int, alpha, device: torch.device) -> torch.Tensor:
    """f32 zipf CDF over ``cats`` categories; ``alpha`` may be a tensor."""
    alpha = torch.as_tensor(alpha, device=device).to(torch.float32)
    ranks = torch.arange(1, cats + 1, dtype=torch.float32, device=device)
    p = torch.pow(ranks, -alpha)
    return torch.cumsum(p / torch.sum(p), 0)


def _zipf_sample(gen: torch.Generator, n: int, cats: int,
                 alpha) -> torch.Tensor:
    """n zipf draws over ``cats`` categories via inverse-CDF search."""
    cdf = _zipf_cdf(cats, alpha, gen.device)
    u = torch.rand(n, generator=gen, device=gen.device)
    return torch.clamp(torch.searchsorted(cdf, u), 0, cats - 1).to(
        torch.int32)


def _bits_u32(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform uint32 words (drawn as int32 and reinterpreted)."""
    return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                         generator=gen, device=gen.device).view(torch.uint32)


# ---------------------------------------------------------------------------
# Keys / text records (gensort analog)
# ---------------------------------------------------------------------------


def gen_keys(gen: torch.Generator, n: int,
             spec: DataSpec = DataSpec()) -> torch.Tensor:
    """Sortable uint32 keys.  zipf gives heavily duplicated (skewed) keys."""
    if spec.distribution == "zipf":
        cats = min(n, 1 << 16)
        return narrow(_zipf_sample(gen, n, cats, spec.zipf_alpha).to(
            torch.int64), torch.uint32)
    if spec.distribution == "normal":
        x = torch.randn(n, generator=gen, device=gen.device) * 0.15 + 0.5
        return narrow((torch.clamp(x, 0, 1) * float(2 ** 30)).to(torch.int64),
                      torch.uint32)
    return _bits_u32(gen, (n,))


def gen_text_records(gen: torch.Generator, n: int, payload_words: int = 4,
                     spec: DataSpec = DataSpec()
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """gensort-like records: (uint32 key, payload_words x uint32 payload)."""
    keys = gen_keys(gen, n, spec)
    payload = _bits_u32(gen, (n, payload_words))
    return keys, payload


# ---------------------------------------------------------------------------
# Vectors (BDGS analog — the K-means input)
# ---------------------------------------------------------------------------


def gen_vectors(gen: torch.Generator, n: int, dim: int,
                spec: DataSpec = DataSpec()) -> torch.Tensor:
    dev = gen.device
    if spec.distribution == "zipf":
        cats = 64
        centers = torch.randn(cats, dim, generator=gen, device=dev) * 2.0
        idx = _zipf_sample(gen, n, cats, spec.zipf_alpha)
        x = centers[idx] + torch.randn(n, dim, generator=gen,
                                       device=dev) * 0.1
    elif spec.distribution == "normal":
        x = torch.randn(n, dim, generator=gen, device=dev)
    else:
        x = torch.rand(n, dim, generator=gen, device=dev) * 2.0 - 1.0
    x = _apply_scale(x, spec.scale)
    x = _apply_sparsity(gen, x, spec.sparsity)
    return x.to(torch_dtype(spec.dtype))


# ---------------------------------------------------------------------------
# Graphs (BDGS analog — the PageRank input)
# ---------------------------------------------------------------------------


def gen_graph(gen: torch.Generator, num_vertices: int, num_edges: int,
              spec: DataSpec = DataSpec()
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge list (src, dst) int32 tensors; zipf skews the destinations."""
    dev = gen.device
    if spec.distribution == "zipf":
        cats = min(num_vertices, 1 << 14)
        dst = _zipf_sample(gen, num_edges, cats, spec.zipf_alpha)
        dst = (dst * (num_vertices // cats + 1)) % num_vertices
        src = torch.randint(0, num_vertices, (num_edges,), generator=gen,
                            device=dev)
    else:
        src = torch.randint(0, num_vertices, (num_edges,), generator=gen,
                            device=dev)
        dst = torch.randint(0, num_vertices, (num_edges,), generator=gen,
                            device=dev)
    return src.to(torch.int32), dst.to(torch.int32)


# ---------------------------------------------------------------------------
# Images (CIFAR / ILSVRC analog)
# ---------------------------------------------------------------------------


def gen_images(gen: torch.Generator, batch: int, height: int, width: int,
               channels: int, layout: str = "NHWC",
               spec: DataSpec = DataSpec()) -> torch.Tensor:
    """Random images with pixel-value statistics like normalized photos."""
    shape = ((batch, height, width, channels) if layout == "NHWC"
             else (batch, channels, height, width))
    if spec.distribution == "normal":
        x = torch.randn(shape, generator=gen, device=gen.device)
    else:
        x = torch.rand(shape, generator=gen, device=gen.device) * 2.0 - 1.0
    x = _apply_scale(x, spec.scale)
    return x.to(torch_dtype(spec.dtype))
