"""Plain input generation for the motif references: the draws each motif
makes from its node's seed, in the same order and at the same shapes, so
that a generator seeded alike gives the same data on the same device.

The program under test is never imported here.  What a proxy node feeds
its motif is part of what the benchmark checks: the reference makes it
again from the seed, and the comparison then holds the program's outputs
to the reference's.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Mapping, Tuple

import numpy as np
import torch

U32 = torch.uint32

#: a node's P as the frozen proxy stores it, with the paper's defaults
P_DEFAULTS = dict(data_size=1 << 16, chunk_size=1 << 12, num_tasks=4,
                  weight=1.0, batch_size=8, total_size=0, height=32,
                  width=32, channels=16, dtype="float32",
                  distribution="uniform", sparsity=0.0, layout="NHWC",
                  dist_scale=1.0, zipf_alpha=1.2, substrate="torch")


def params(p: Mapping) -> SimpleNamespace:
    """A node's P as attributes; unknown keys are refused."""
    unknown = set(p) - set(P_DEFAULTS)
    if unknown:
        raise KeyError(f"unknown P fields {sorted(unknown)}")
    return SimpleNamespace(**{**P_DEFAULTS, **p})


def repeats(p) -> int:
    """Invocations of a node: its weight rounded half to even, at least 1."""
    return max(int(round(p.weight)), 1)


def derive_seed(*parts: int) -> int:
    """A 63-bit seed from integers (numpy's ``SeedSequence``)."""
    state = np.random.SeedSequence([int(x) for x in parts]).generate_state(
        1, np.uint64)[0]
    return int(state >> np.uint64(1))


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def dtype_of(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def u32_from_i64(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as uint32 (through their int32 bits)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32).view(U32)


def bits_u32(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                         generator=gen, device=gen.device).view(U32)


def _f32(v: float, device) -> torch.Tensor:
    return torch.scalar_tensor(v, dtype=torch.float32, device=device)


def scaled(x: torch.Tensor, scale: float) -> torch.Tensor:
    if float(scale) == 1.0:
        return x
    return x * _f32(scale, x.device).to(x.dtype)


def sparsified(gen: torch.Generator, x: torch.Tensor,
               sparsity: float) -> torch.Tensor:
    if float(sparsity) <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < (
        1.0 - _f32(sparsity, x.device))
    return torch.where(keep, x, torch.zeros_like(x))


def zipf(gen: torch.Generator, n: int, cats: int, alpha: float) -> torch.Tensor:
    """n draws over ``cats`` categories by inverse CDF, as int32."""
    ranks = torch.arange(1, cats + 1, dtype=torch.float32, device=gen.device)
    w = torch.pow(ranks, -_f32(alpha, gen.device))
    cdf = torch.cumsum(w / torch.sum(w), 0)
    u = torch.rand(n, generator=gen, device=gen.device)
    return torch.clamp(torch.searchsorted(cdf, u), 0, cats - 1).to(torch.int32)


def vectors(gen: torch.Generator, n: int, dim: int, p) -> torch.Tensor:
    dev = gen.device
    if p.distribution == "zipf":
        centers = torch.randn(64, dim, generator=gen, device=dev) * 2.0
        idx = zipf(gen, n, 64, p.zipf_alpha)
        x = centers[idx] + torch.randn(n, dim, generator=gen, device=dev) * 0.1
    elif p.distribution == "normal":
        x = torch.randn(n, dim, generator=gen, device=dev)
    else:
        x = torch.rand(n, dim, generator=gen, device=dev) * 2.0 - 1.0
    x = sparsified(gen, scaled(x, p.dist_scale), p.sparsity)
    return x.to(dtype_of(p.dtype))


def keys(gen: torch.Generator, n: int, p) -> torch.Tensor:
    """uint32 sort keys."""
    if p.distribution == "zipf":
        return u32_from_i64(zipf(gen, n, min(n, 1 << 16), p.zipf_alpha)
                            .to(torch.int64))
    if p.distribution == "normal":
        x = torch.randn(n, generator=gen, device=gen.device) * 0.15 + 0.5
        return u32_from_i64((torch.clamp(x, 0, 1) * float(2 ** 30))
                            .to(torch.int64))
    return bits_u32(gen, (n,))


def records(gen: torch.Generator, n: int, words: int,
            p) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uint32 keys, uint32 payload of ``words`` a key)."""
    k = keys(gen, n, p)
    return k, bits_u32(gen, (n, words))


def graph(gen: torch.Generator, nv: int, ne: int,
          p) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 edge list (src, dst); zipf skews the destinations."""
    dev = gen.device
    if p.distribution == "zipf":
        cats = min(nv, 1 << 14)
        dst = (zipf(gen, ne, cats, p.zipf_alpha) * (nv // cats + 1)) % nv
        src = torch.randint(0, nv, (ne,), generator=gen, device=dev)
    else:
        src = torch.randint(0, nv, (ne,), generator=gen, device=dev)
        dst = torch.randint(0, nv, (ne,), generator=gen, device=dev)
    return src.to(torch.int32), dst.to(torch.int32)


def images(gen: torch.Generator, p) -> torch.Tensor:
    """A batch of P's images, NHWC or NCHW by ``p.layout``."""
    b = max(p.batch_size, 1)
    shape = ((b, p.height, p.width, p.channels) if p.layout == "NHWC"
             else (b, p.channels, p.height, p.width))
    if p.distribution == "normal":
        x = torch.randn(shape, generator=gen, device=gen.device)
    else:
        x = torch.rand(shape, generator=gen, device=gen.device) * 2.0 - 1.0
    return scaled(x, p.dist_scale).to(dtype_of(p.dtype))


def seed_leaf(gen: torch.Generator) -> torch.Tensor:
    """A 0-d int32 seed drawn from ``gen``: a motif's own random stream."""
    return torch.randint(0, 1 << 31, (), generator=gen, device=gen.device,
                         dtype=torch.int32)


def chunk_layout(n: int, p) -> Tuple[int, int, int]:
    """(tasks, per, chunk) of the paper's execution model over ``n`` rows:
    whole (task, chunk) blocks, the rest left out."""
    chunk = max(min(p.chunk_size, n), 1)
    tasks = max(min(p.num_tasks, max(n // chunk, 1)), 1)
    per = max(n // (tasks * chunk), 1)
    return tasks, per, chunk


def chunked(x: torch.Tensor, p) -> torch.Tensor:
    tasks, per, chunk = chunk_layout(x.shape[0], p)
    return x[:tasks * per * chunk].reshape(
        (tasks, per, chunk) + tuple(x.shape[1:]))
