"""Candidate evaluation for the proxy tuner (port of the
``ExecutableCache``/``BatchEvaluator`` part of ``repro/core/evaluator.py``).

A candidate's profiled metrics are a function of its
:meth:`ProxyBenchmark.shape_signature`: equal signatures run the same ops
at the same shapes, and the lifted knobs (sparsity, dist_scale,
zipf_alpha) enter only as values.  So candidates are grouped by
signature; the first time a signature is seen its eval form is profiled
once (the port's "compile") and its ``Signature`` cached in an LRU, with
the lifted values of that first candidate as its example input.  With
``run=True`` each signature's wall time is measured once, on that
example.  Batched metrics therefore equal serial ones.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.accuracy import normalized_vector
from repro_torch.core.motifs.base import (
    DEFAULT_EVAL_BATCH,
    DEFAULT_EVAL_CACHE,
    EVAL_BATCH_BOUNDS,
    EVAL_CACHE_BOUNDS,
)
from repro_torch.core.proxy_graph import ProxyBenchmark
from repro_torch.core.signature import Signature, measure_wall_time, profile_call
from repro_torch.device import DeviceLike, resolve_device


def _clamp(v: int, bounds: Tuple[int, int]) -> int:
    return int(min(max(v, bounds[0]), bounds[1]))


@dataclass
class CacheEntry:
    """One profiled shape class: its eval-form runner, the lifted values
    it was first profiled with, its signature and metrics."""

    fn: Callable
    lifted_example: torch.Tensor
    signature: Signature
    wall_time: Optional[float] = None
    metrics: Optional[Dict[str, float]] = None


class ExecutableCache:
    """LRU cache of profiled shape classes keyed by ``shape_signature``."""

    def __init__(self, capacity: int = DEFAULT_EVAL_CACHE,
                 device: DeviceLike = None):
        self.capacity = _clamp(capacity, EVAL_CACHE_BOUNDS)
        self.device = resolve_device(device)
        self._entries: "OrderedDict[Tuple, CacheEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.compiles = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def key_for(self, pb: ProxyBenchmark) -> Tuple:
        return pb.shape_signature()

    def lookup(self, sig_key: Tuple) -> Optional[CacheEntry]:
        entry = self._entries.get(sig_key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(sig_key)
        self.hits += 1
        return entry

    def insert(self, sig_key: Tuple, entry: CacheEntry) -> CacheEntry:
        self._entries[sig_key] = entry
        self._entries.move_to_end(sig_key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
        return entry

    def compile_entry(self, pb: ProxyBenchmark, seed: int) -> CacheEntry:
        """Profile one shape class's eval form once (no caching)."""
        vals = pb.lifted_values(self.device)
        fn = pb.build_eval_fn(self.device)
        sig = profile_call(fn, seed, vals)
        self.compiles += 1
        return CacheEntry(fn=fn, lifted_example=vals, signature=sig)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "compiles": self.compiles, "evictions": self.evictions,
                "entries": len(self._entries)}


class BatchEvaluator:
    """Evaluate candidate populations: dedup by shape class, profile once,
    cache.  Callable on one proxy (the tuner's ``EvalFn``) plus an
    ``evaluate_batch`` for whole impact-analysis batches; ``metrics``
    filters the returned vector the way ``proxy_metrics`` does."""

    def __init__(self, *, run: bool = True,
                 metrics: Optional[Sequence[str]] = None,
                 seed: int = 0,
                 cache: Optional[ExecutableCache] = None,
                 capacity: int = DEFAULT_EVAL_CACHE,
                 max_batch: int = DEFAULT_EVAL_BATCH,
                 wall_iters: int = 5,
                 device: DeviceLike = None):
        self.run = run
        self.metrics = list(metrics) if metrics is not None else None
        self.seed = seed
        self.cache = (cache if cache is not None
                      else ExecutableCache(capacity, device=device))
        if device is not None and resolve_device(device) != self.cache.device:
            raise ValueError("shared cache was built for another device")
        self.max_batch = _clamp(max_batch, EVAL_BATCH_BOUNDS)
        self.wall_iters = wall_iters
        self.evals = 0

    @property
    def device(self) -> torch.device:
        return self.cache.device

    def __call__(self, pb: ProxyBenchmark) -> Dict[str, float]:
        return self.evaluate(pb)

    def evaluate(self, pb: ProxyBenchmark) -> Dict[str, float]:
        return self.evaluate_batch([pb])[0]

    def evaluate_batch(self, pbs: Sequence[ProxyBenchmark]
                       ) -> List[Dict[str, float]]:
        """Metric vectors for a candidate population, in order."""
        results: List[Dict[str, float]] = []
        for lo in range(0, len(pbs), self.max_batch):
            results.extend(self._eval_chunk(pbs[lo:lo + self.max_batch]))
        self.evals += len(pbs)
        return results

    def _eval_chunk(self, pbs: Sequence[ProxyBenchmark]
                    ) -> List[Dict[str, float]]:
        sig_keys = [self.cache.key_for(pb) for pb in pbs]
        entries: Dict[Tuple, CacheEntry] = {}
        for sk, pb in zip(sig_keys, pbs):
            if sk in entries:
                continue
            entry = self.cache.lookup(sk)
            if entry is None:
                entry = self.cache.insert(
                    sk, self.cache.compile_entry(pb, self.seed))
            entries[sk] = entry
        for entry in entries.values():
            self._finalize(entry)
        return [self._filtered(entries[sk]) for sk in sig_keys]

    def _finalize(self, entry: CacheEntry) -> None:
        if self.run and entry.wall_time is None:
            entry.wall_time = measure_wall_time(
                lambda: entry.fn(self.seed, entry.lifted_example),
                iters=self.wall_iters, device=self.device)
            entry.signature.wall_time = entry.wall_time
            entry.metrics = None  # rates depend on wall time
        if entry.metrics is None:
            entry.metrics = normalized_vector(entry.signature,
                                              include_rates=self.run)

    def _filtered(self, entry: CacheEntry) -> Dict[str, float]:
        m = entry.metrics or {}
        if self.metrics is None:
            return dict(m)
        return {k: m.get(k, 0.0) for k in self.metrics}

    def signature_of(self, pb: ProxyBenchmark) -> Signature:
        """Full :class:`Signature` of ``pb``, reusing cached profiles."""
        sk = self.cache.key_for(pb)
        entry = self.cache.lookup(sk)
        if entry is None:
            entry = self.cache.insert(sk,
                                      self.cache.compile_entry(pb, self.seed))
        self._finalize(entry)
        return entry.signature

    def stats(self) -> Dict[str, int]:
        s = self.cache.stats()
        s["evals"] = self.evals
        return s
