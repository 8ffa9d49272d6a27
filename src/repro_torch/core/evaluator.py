"""Shared cross-workload candidate evaluation for the proxy tuner (port of
``repro/core/evaluator.py``: ``ExecutableCache``, ``BatchEvaluator``,
``EvalSession`` and ``serial_evaluate_batch``).

A candidate's profiled metrics are a function of its
:meth:`ProxyBenchmark.shape_signature`: equal signatures run the same ops
at the same shapes, and the lifted knobs (sparsity, dist_scale,
zipf_alpha) enter only as values.  So candidates are grouped by
signature; the first time a signature is seen its eval form is profiled
once (the port's "compile") and its ``Signature`` cached in an LRU, with
the lifted values of that first candidate as its example input.  With
``run=True`` each signature's wall time is measured once, on that
example: a captured CUDA graph's replays where the eval form can be
captured, else eager dispatch, as
:func:`~repro_torch.core.signature.timed_wall` records.  Batched metrics
therefore equal serial ones.

:class:`EvalSession` scopes this to a whole multi-workload run (the
paper-repro sweep): one :class:`ExecutableCache` shared across every
``generate_proxy`` call, so later workloads warm-start from shape classes
profiled for earlier ones.  ``session.workload(name)`` tags cache traffic
per workload and counts **cross-workload hits** — cache hits served by
an entry another workload profiled.  A :class:`~repro_torch.core.store.
ProxyStore` behind the cache makes the warm start survive the process.

Not ported: the reference's population form (``PopulationRegistry``,
``population_runtime``), its compile-worker pool, and its mesh and rules
arguments.
"""
from __future__ import annotations

from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.accuracy import normalized_vector
from repro_torch.core.motifs.base import (
    DEFAULT_EVAL_BATCH,
    DEFAULT_EVAL_CACHE,
    EVAL_BATCH_BOUNDS,
    EVAL_CACHE_BOUNDS,
    SUBSTRATES,
)
from repro_torch.core.proxy_graph import ProxyBenchmark
from repro_torch.core.signature import Signature, profile_call, timed_wall
from repro_torch.core.store import canonical_key, device_key, key_digest
from repro_torch.device import DeviceLike, resolve_device


def _clamp(v: int, bounds: Tuple[int, int]) -> int:
    return int(min(max(v, bounds[0]), bounds[1]))


def _default_telemetry():
    """The process-default telemetry hub, resolved when an engine is
    built (core modules import nothing of ``repro_torch.runtime`` at
    module level, as in the reference)."""
    from repro_torch.runtime.telemetry import get_default

    return get_default()


def _key_attr(sig_key: Tuple) -> str:
    """Short key digest for span/event attributes (the first 12 hex
    chars of the store digest).  Only computed when telemetry is
    enabled; callers guard."""
    return key_digest(canonical_key(sig_key))[:12]


@dataclass
class CacheEntry:
    """One profiled shape class: its eval-form runner, the lifted values
    it was first profiled with, its signature and metrics.

    ``owner`` is the workload scope that profiled the entry (see
    :meth:`EvalSession.workload`).  An entry served by a persistent
    store carries the exact signature and wall time of the program it
    describes but no runner (``fn=None``): its metrics are served without
    a profile.  ``sig_key`` is set at insert time so the
    entry can be persisted after finalization."""

    fn: Optional[Callable]
    lifted_example: Optional[torch.Tensor]
    signature: Signature
    wall_time: Optional[float] = None
    metrics: Optional[Dict[str, float]] = None
    owner: Optional[str] = None
    sig_key: Optional[Tuple] = None
    persisted: bool = False
    #: memoized short key digest for telemetry attrs
    key_attr: Optional[str] = None


class ExecutableCache:
    """LRU cache of profiled shape classes keyed by ``shape_signature``.

    ``scope`` names the workload currently driving the cache (set by
    :meth:`EvalSession.workload`); a hit on an entry owned by a different
    scope increments ``cross_scope_hits``.

    ``store`` (a :class:`~repro_torch.core.store.ProxyStore`) makes the
    cache persistent across processes: an in-memory miss consults the
    store before profiling, and finalized entries are written back.  The
    store key is the in-memory key followed by this cache's device key
    (:func:`~repro_torch.core.store.device_key`), so an entry measured on
    another device is a miss.  ``need_wall`` records whether this cache's
    engine measures wall time, which a store entry must match to be
    served."""

    def __init__(self, capacity: int = DEFAULT_EVAL_CACHE,
                 device: DeviceLike = None, store=None, telemetry=None):
        self.capacity = _clamp(capacity, EVAL_CACHE_BOUNDS)
        self.device = resolve_device(device)
        self.store = store
        self.device_key = device_key(self.device)
        #: telemetry hub: cache.hit / cache.store_hit / cache.store_invalid
        #: instants, eval.trace + eval.compile spans, store.load /
        #: store.save spans.  Defaults to the process hub (NULL unless
        #: REPRO_TRACE=1) — a strict no-op.
        self.telemetry = (telemetry if telemetry is not None
                          else _default_telemetry())
        self.need_wall = False
        self._entries: "OrderedDict[Tuple, CacheEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.compiles = 0
        self.evictions = 0
        self.scope: Optional[str] = None
        self.cross_scope_hits = 0

    def __len__(self) -> int:
        return len(self._entries)

    def key_for(self, pb: ProxyBenchmark) -> Tuple:
        return pb.shape_signature()

    def store_key(self, sig_key: Tuple) -> Tuple:
        """The persistent key of an in-memory key: the device key
        appended."""
        return sig_key + (self.device_key,)

    def lookup(self, sig_key: Tuple) -> Optional[CacheEntry]:
        entry = self._entries.get(sig_key)
        if entry is None:
            self.misses += 1  # an in-memory miss, whatever the store says
            entry = self._store_lookup(sig_key)
            if entry is not None:
                return self.insert(sig_key, entry)
            return None
        self._entries.move_to_end(sig_key)
        self.hits += 1
        if (entry.owner is not None and self.scope is not None
                and entry.owner != self.scope):
            self.cross_scope_hits += 1
        if self.telemetry.enabled:
            if entry.key_attr is None:
                entry.key_attr = _key_attr(sig_key)
            self.telemetry.event("cache.hit", key=entry.key_attr)
        return entry

    def _store_lookup(self, sig_key: Tuple) -> Optional[CacheEntry]:
        """A metrics-only entry served from the persistent store, or
        None.  Any store problem (corrupt, stale, wrong run mode, another
        device) is a miss: the cold profile stays the fallback."""
        if self.store is None:
            return None
        tel = self.telemetry
        skey = self.store_key(sig_key)
        digest = None
        if not tel.enabled:
            sig = self.store.get_signature(skey, need_wall=self.need_wall)
        else:
            digest = _key_attr(sig_key)
            invalid_before = self.store.invalid
            with tel.span("store.load", key=digest) as sp:
                sig = self.store.get_signature(skey,
                                               need_wall=self.need_wall)
                sp.set(hit=sig is not None)
            # the store never raises on a bad entry; the only signal that
            # a present-but-corrupt/stale file was skipped is its counter
            if self.store.invalid > invalid_before:
                tel.event("cache.store_invalid", key=digest)
            elif sig is not None:
                tel.event("cache.store_hit", key=digest)
        if sig is None:
            return None
        return CacheEntry(fn=None, lifted_example=None, signature=sig,
                          wall_time=sig.wall_time, persisted=True,
                          key_attr=digest)

    def insert(self, sig_key: Tuple, entry: CacheEntry) -> CacheEntry:
        if entry.owner is None:
            entry.owner = self.scope
        if entry.sig_key is None:
            entry.sig_key = sig_key
        self._entries[sig_key] = entry
        self._entries.move_to_end(sig_key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
        return entry

    def persist(self, entry: CacheEntry) -> None:
        """Write one finalized entry through to the persistent store
        (no-op without a store, or if already persisted).  Only the
        store's own write failure is swallowed: persistence may never
        cost a tuning run."""
        if (self.store is None or entry.persisted
                or entry.sig_key is None):
            return
        if self.telemetry.enabled and entry.key_attr is None:
            entry.key_attr = _key_attr(entry.sig_key)
        with self.telemetry.span("store.save", key=entry.key_attr or ""):
            try:
                self.store.put_signature(self.store_key(entry.sig_key),
                                         entry.signature,
                                         run=entry.wall_time is not None)
            except OSError:  # a full disk must not kill tuning
                return
        entry.persisted = True

    def get_or_build(self, sig_key: Tuple,
                     build: Callable[[], CacheEntry]) -> CacheEntry:
        """Generic cached build: LRU lookup, else ``build()`` + insert.
        ``build`` bumps ``self.compiles`` itself if it wants compile
        accounting."""
        entry = self.lookup(sig_key)
        if entry is None:
            entry = self.insert(sig_key, build())
        return entry

    def compile_entry(self, pb: ProxyBenchmark, seed: int) -> CacheEntry:
        """Profile one shape class's eval form once (no caching): build
        its runner (span ``eval.trace``), then one profiled dispatch run
        (span ``eval.compile``)."""
        tel = self.telemetry
        kd = _key_attr(self.key_for(pb)) if tel.enabled else ""
        with tel.span("eval.trace", key=kd):
            vals = pb.lifted_values(self.device)
            fn = pb.build_eval_fn(self.device)
        with tel.span("eval.compile", key=kd):
            sig = profile_call(fn, seed, vals)
        self.compiles += 1
        return CacheEntry(fn=fn, lifted_example=vals, signature=sig,
                          key_attr=kd or None)

    def stats(self) -> Dict[str, int]:
        s = {"hits": self.hits, "misses": self.misses,
             "compiles": self.compiles, "evictions": self.evictions,
             "cross_workload_hits": self.cross_scope_hits,
             "entries": len(self._entries)}
        if self.store is not None:
            s.update(self.store.stats())
        return s


class BatchEvaluator:
    """Evaluate candidate populations: dedup by shape class, profile once,
    cache.  Callable on one proxy (the tuner's ``EvalFn``) plus an
    ``evaluate_batch`` for whole impact-analysis batches; ``metrics``
    filters the returned vector the way ``proxy_metrics`` does.

    Pass ``cache`` to share profiled state across evaluators, or use
    :class:`EvalSession`, which owns one for a whole multi-workload run.
    """

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
        # a run=True engine only accepts store entries with measured wall
        # time (and vice versa) — see ExecutableCache._store_lookup
        self.cache.need_wall = self.cache.need_wall or run
        self.max_batch = _clamp(max_batch, EVAL_BATCH_BOUNDS)
        self.wall_iters = wall_iters
        self.evals = 0

    @property
    def device(self) -> torch.device:
        return self.cache.device

    @property
    def telemetry(self):
        """The hub this engine emits on (the cache owns it)."""
        return self.cache.telemetry

    def __call__(self, pb: ProxyBenchmark) -> Dict[str, float]:
        return self.evaluate(pb)

    def evaluate(self, pb: ProxyBenchmark) -> Dict[str, float]:
        return self.evaluate_batch([pb])[0]

    def evaluate_batch(self, pbs: Sequence[ProxyBenchmark]
                       ) -> List[Dict[str, float]]:
        """Metric vectors for a candidate population, in order."""
        with self.telemetry.span("eval.batch", candidates=len(pbs)):
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
            if sk not in entries:
                entries[sk] = self._entry(sk, pb)
        for entry in entries.values():
            self._finalize(entry)
        return [self._filtered(entries[sk]) for sk in sig_keys]

    def _entry(self, sk: Tuple, pb: ProxyBenchmark) -> CacheEntry:
        return self.cache.get_or_build(
            sk, lambda: self.cache.compile_entry(pb, self.seed))

    def _finalize(self, entry: CacheEntry) -> None:
        if self.run and entry.wall_time is None:
            tel = self.telemetry
            if (tel.enabled and entry.key_attr is None
                    and entry.sig_key is not None):
                entry.key_attr = _key_attr(entry.sig_key)
            with tel.span("eval.execute", key=entry.key_attr or "",
                          iters=self.wall_iters):
                entry.wall_time, entry.signature.timing = timed_wall(
                    lambda: entry.fn(self.seed, entry.lifted_example),
                    iters=self.wall_iters, device=self.device)
            entry.signature.wall_time = entry.wall_time
            entry.metrics = None  # rates depend on wall time
        if entry.metrics is None:
            entry.metrics = normalized_vector(entry.signature,
                                              include_rates=self.run)
        # a finalized entry is durable: write it through to the store
        self.cache.persist(entry)

    def _filtered(self, entry: CacheEntry) -> Dict[str, float]:
        m = entry.metrics or {}
        if self.metrics is None:
            return dict(m)
        return {k: m.get(k, 0.0) for k in self.metrics}

    def signature_of(self, pb: ProxyBenchmark) -> Signature:
        """Full :class:`Signature` of ``pb``, reusing cached profiles."""
        entry = self._entry(self.cache.key_for(pb), pb)
        self._finalize(entry)
        return entry.signature

    def stats(self) -> Dict[str, int]:
        s = self.cache.stats()
        s["evals"] = self.evals
        return s


class EvalSession:
    """Session-scoped engine for an entire multi-workload run.

    Owns one :class:`ExecutableCache` and exposes one
    :class:`BatchEvaluator` over it, so the paper-repro sweep (five
    workloads, one ``generate_proxy`` each) reuses profiles across
    workloads.  The session quacks like a ``BatchEvaluator`` (callable,
    with ``evaluate_batch`` / ``signature_of`` / ``metrics`` / ``stats``),
    so it can be passed as ``DecisionTreeTuner(evaluate=session)`` or
    ``generate_proxy(..., session=session)``.

    ``workload(name)`` scopes a stretch of evaluation to one workload:
    entries profiled inside it are tagged ``name``, hits on entries
    tagged by a different workload count as cross-workload hits, and the
    per-workload stats delta is recorded in ``workload_stats``.

    ``priors=True`` makes every ``generate_proxy`` routed through the
    session prior-seeded by default, and ``substrate`` is the default
    substrate of those calls; both are threaded, not enforced.

    ::

        session = EvalSession(run=True, seed=0, substrate="hopper")
        for name, w in WORKLOADS.items():
            pb, rep = generate_proxy(w.step, *args, name=name,
                                     session=session)
        print(session.stats()["cross_workload_hits"])
    """

    def __init__(self, *, run: bool = True, seed: int = 0,
                 capacity: int = DEFAULT_EVAL_CACHE,
                 max_batch: int = DEFAULT_EVAL_BATCH,
                 wall_iters: int = 5,
                 priors: bool = False,
                 substrate: str = "torch",
                 store=None,
                 telemetry=None,
                 device: DeviceLike = None):
        if substrate not in SUBSTRATES:
            raise ValueError(f"unknown substrate {substrate!r} "
                             f"(have {SUBSTRATES})")
        #: persistent cross-process store; in-memory misses consult it
        #: before profiling and finalized entries write through
        self.store = store
        self.cache = ExecutableCache(capacity, device=device, store=store,
                                     telemetry=telemetry)
        #: default for generate_proxy(..., priors=None) calls routed
        #: through this session
        self.priors = bool(priors)
        #: default for generate_proxy(..., substrate=None) calls; the
        #: knob lives in each node's P (structural in the cache key), so
        #: one session can hold entries for both substrates
        self.substrate = substrate
        self.engine = BatchEvaluator(run=run, seed=seed, cache=self.cache,
                                     max_batch=max_batch,
                                     wall_iters=wall_iters)
        #: per-workload stats deltas, in sweep order
        self.workload_stats: "OrderedDict[str, Dict[str, int]]" = OrderedDict()
        # one snapshot() on the hub now supersets this session's stats()
        self.telemetry.register_provider("engine", self.stats)

    @property
    def device(self) -> torch.device:
        return self.cache.device

    @property
    def telemetry(self):
        """The hub every stage of this session emits on; NULL unless one
        was passed or ``REPRO_TRACE=1`` is set."""
        return self.cache.telemetry

    def set_telemetry(self, hub) -> Any:
        """Swap the session's hub in place; returns the previous hub."""
        from repro_torch.runtime.telemetry import NULL

        prev = self.cache.telemetry
        self.cache.telemetry = hub if hub is not None else NULL
        self.cache.telemetry.register_provider("engine", self.stats)
        return prev

    # -- evaluator protocol (delegation) ------------------------------------
    @property
    def run(self) -> bool:
        return self.engine.run

    @property
    def seed(self) -> int:
        return self.engine.seed

    @property
    def metrics(self) -> Optional[List[str]]:
        return self.engine.metrics

    @metrics.setter
    def metrics(self, names: Optional[Sequence[str]]) -> None:
        self.engine.metrics = list(names) if names is not None else None

    def __call__(self, pb: ProxyBenchmark) -> Dict[str, float]:
        return self.engine(pb)

    def evaluate(self, pb: ProxyBenchmark) -> Dict[str, float]:
        return self.engine.evaluate(pb)

    def evaluate_batch(self, pbs: Sequence[ProxyBenchmark]
                       ) -> List[Dict[str, float]]:
        return self.engine.evaluate_batch(pbs)

    def signature_of(self, pb: ProxyBenchmark) -> Signature:
        return self.engine.signature_of(pb)

    @property
    def evals(self) -> int:
        return self.engine.evals

    def stats(self) -> Dict[str, int]:
        return self.engine.stats()

    @property
    def cross_workload_hits(self) -> int:
        return self.cache.cross_scope_hits

    # -- workload scoping ----------------------------------------------------
    @contextmanager
    def workload(self, name: str):
        """Scope evaluation to one workload of the sweep.

        Entries profiled inside the block are tagged ``name``; hits on
        other workloads' entries count toward ``cross_workload_hits``.
        The block's stats delta accumulates into ``workload_stats[name]``.
        Yields the shared engine.  Re-entrant across workloads but not
        nestable."""
        if self.cache.scope is not None:
            raise RuntimeError(
                f"workload scope {self.cache.scope!r} already active")
        before = self.stats()
        self.cache.scope = name
        try:
            yield self.engine
        finally:
            self.cache.scope = None
            acc = self.workload_stats.setdefault(name, {})
            for k, v in counter_delta(before, self.stats()).items():
                acc[k] = acc.get(k, 0) + v


def counter_delta(before: Dict[str, int], after: Dict[str, int]
                  ) -> Dict[str, int]:
    """``after - before`` for the counters of a stats dict; the gauges
    (``...entries``, ``..._max``) are dropped: their deltas mean
    nothing."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if not (k.endswith("entries") or k.endswith("_max"))}


def serial_evaluate_batch(pbs: Sequence[ProxyBenchmark], *, run: bool = True,
                          metrics: Optional[Sequence[str]] = None,
                          seed: int = 0, lifted: bool = False,
                          device: DeviceLike = None
                          ) -> List[Dict[str, float]]:
    """The serial reference: one profile (+ timing) per candidate, no
    sharing of anything.

    ``lifted=False`` profiles the fully static build (every P value baked
    in, ``proxy_metrics(form="static")``), the historical baseline.
    ``lifted=True`` profiles each candidate's eval form instead, the
    program the engine caches: the parity reference for
    :meth:`BatchEvaluator.evaluate_batch`, whose profiled metrics must
    match it exactly."""
    if not lifted:
        from repro_torch.core.generator import proxy_metrics

        return [proxy_metrics(pb, run=run, metrics=metrics, seed=seed,
                              form="static", device=device)
                for pb in pbs]

    dev = resolve_device(device)
    out: List[Dict[str, float]] = []
    for pb in pbs:
        vals = pb.lifted_values(dev)
        fn = pb.build_eval_fn(dev)
        sig = profile_call(fn, seed, vals)
        if run:
            sig.wall_time, sig.timing = timed_wall(lambda: fn(seed, vals),
                                                   device=dev)
        m = normalized_vector(sig, include_rates=run)
        if metrics is not None:
            m = {k: m.get(k, 0.0) for k in metrics}
        out.append(m)
    return out
