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

A function that makes its generators through :func:`make_generator` and
:func:`generator_from` can be captured as a CUDA graph: under a
:class:`GeneratorSupply` both are answered from generators made before
the capture (see :mod:`repro_torch.core.signature`).  Apart from
:func:`generator_from`'s seed read, which the supply answers, nothing
here reads a tensor back to the host or copies one from it, which a
capture refuses.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

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


class GeneratorSupply:
    """The generators of one function, made before it is captured as a
    CUDA graph.

    A graph replays a random draw only from a generator registered with
    it before the capture, and a capture may not read a tensor back to
    the host.  So the function first runs eagerly under
    :meth:`recording` (once or more), where every :func:`make_generator`
    and :func:`generator_from` call is answered as usual and its seed
    noted; :meth:`prepare` then makes one generator per call, seeded as
    that call's was, for the graph to register; under :meth:`capturing`
    the calls are answered from them, in order, with no host read; and
    :meth:`reset` reseeds them before each replay, so that every replay
    draws what the eager run drew.

    The function must ask for the same seeds in the same order on every
    call: a recording that differs from the first, or a capture that asks
    :func:`make_generator` for another seed, raises.  A seed leaf that
    :func:`generator_from` reads is taken at its recorded value: every
    such leaf of this package is drawn by :func:`gen_seed` from a
    generator of the call's own seeds, so it is the same at every call."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seeds: Optional[List[int]] = None
        self.generators: List[torch.Generator] = []
        self._calls: Optional[List[int]] = None
        self._capturing = False

    @contextlib.contextmanager
    def recording(self) -> Iterator["GeneratorSupply"]:
        calls: List[int] = []
        with self._active():
            self._calls = calls
            try:
                yield self
            finally:
                self._calls = None
        if self.seeds is None:
            self.seeds = calls
        elif calls != self.seeds:
            raise RuntimeError(
                f"the function asked for {len(calls)} generators "
                f"{calls[:4]}... in one run and {len(self.seeds)} "
                f"{self.seeds[:4]}... in another")

    def prepare(self) -> List[torch.Generator]:
        """One generator per recorded call, seeded as that call's was."""
        self.generators = [torch.Generator(device=self.device)
                           for _ in self.seeds or ()]
        self.reset()
        return self.generators

    def reset(self) -> None:
        for gen, seed in zip(self.generators, self.seeds or ()):
            gen.manual_seed(seed)

    @contextlib.contextmanager
    def capturing(self) -> Iterator["GeneratorSupply"]:
        with self._active():
            self._capturing, self._next = True, 0
            try:
                yield self
            finally:
                self._capturing = False

    @contextlib.contextmanager
    def _active(self) -> Iterator[None]:
        prev = getattr(_SUPPLY, "current", None)
        _SUPPLY.current = self
        try:
            yield
        finally:
            _SUPPLY.current = prev

    def _take(self, seed: Optional[int]) -> torch.Generator:
        i = self._next
        if i >= len(self.generators):
            raise RuntimeError(f"the captured run asked for more than the "
                               f"{len(self.generators)} generators recorded")
        if seed is not None and seed != self.seeds[i]:
            raise RuntimeError(f"the captured run asked generator {i} for "
                               f"seed {seed}, recorded {self.seeds[i]}")
        self._next = i + 1
        return self.generators[i]


#: the supply answering this thread's generator calls, if any
_SUPPLY = threading.local()


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    supply = getattr(_SUPPLY, "current", None)
    if supply is not None:
        if supply._capturing:
            return supply._take(int(seed))
        supply._calls.append(int(seed))
    return torch.Generator(device=device).manual_seed(int(seed))


def gen_seed(gen: torch.Generator) -> torch.Tensor:
    """A 0-d int32 seed drawn from ``gen``, on its device: the port's leaf
    for a JAX PRNG key.  Like a key, it is never perturbed between weighted
    repetitions (``_tree_perturb`` leaves int32 alone)."""
    return torch.randint(0, 1 << 31, (), generator=gen, device=gen.device,
                         dtype=torch.int32)


def generator_from(seed: torch.Tensor) -> torch.Generator:
    """The generator a :func:`gen_seed` leaf stands for.  Reading the leaf
    waits for its device, except under a capturing
    :class:`GeneratorSupply`, which answers from the value recorded."""
    supply = getattr(_SUPPLY, "current", None)
    if supply is not None and supply._capturing:
        return supply._take(None)
    return make_generator(int(seed), seed.device)


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


def _scalar(v, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``v`` (a Python number or a tensor) as a 0-d tensor on ``device``.
    A number is filled in on the device (``scalar_tensor``), never copied
    from the host as ``torch.as_tensor`` would: a copy waits for the
    host, which a CUDA graph capture refuses.  The value is the same."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.scalar_tensor(v, dtype=dtype, device=device)


def _apply_sparsity(gen: torch.Generator, x: torch.Tensor,
                    sparsity) -> torch.Tensor:
    """Zero a ``sparsity`` fraction of ``x``; ``sparsity`` may be a tensor."""
    if isinstance(sparsity, (int, float)) and float(sparsity) <= 0.0:
        return x
    keep_p = 1.0 - _scalar(sparsity, torch.float32, x.device)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_p
    return torch.where(keep, x, torch.zeros_like(x))


def _apply_scale(x: torch.Tensor, scale) -> torch.Tensor:
    """Multiply float data by the distribution scale (tensor or float)."""
    if isinstance(scale, (int, float)) and float(scale) == 1.0:
        return x
    return x * _scalar(scale, torch.float32, x.device).to(x.dtype)


def _zipf_cdf(cats: int, alpha, device: torch.device) -> torch.Tensor:
    """f32 zipf CDF over ``cats`` categories; ``alpha`` may be a tensor."""
    alpha = _scalar(alpha, torch.float32, device)
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
