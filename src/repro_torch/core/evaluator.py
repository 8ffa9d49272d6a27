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
Shape classes missing from the cache are profiled in a pool of threads
(``compile_workers``; the finalize and any capture stay serial after it).

The *population form* (:meth:`ProxyBenchmark.build_lifted_fn`) lifts the
weight too: :meth:`BatchEvaluator.population_runtime` groups candidates by
their weight-free shape class and runs each class's members through
``torch.func.vmap`` of one population-form runner, kept in a
:class:`PopulationRegistry`, ``max_batch`` lanes a call.  A class whose
population form cannot be vmapped — an op with no batching rule, which
functorch would otherwise run once a lane in silence, or a host read —
runs lane by lane and says why.

A ``mesh`` (a ``DeviceMesh``, one cluster scenario) pins an engine to
that scenario: its structural key joins every cache key, each shape
class is profiled and timed under :func:`~repro_torch.distributed.
sharding.use_mesh` with the engine's ``rules`` (the proxy's inputs
sharded, its collectives in the profile), every rank of the mesh takes
the first rank's profile and the slowest rank's wall, and the profiling
pool is one thread, so every rank issues its collectives in one order.
The population form splits its lanes across the mesh's ranks instead:
lanes are independent, so each rank runs its share and the walls are
gathered.  ``mesh=None`` is the single-device path, its keys unchanged.
"""
from __future__ import annotations

import os
import re
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import torch

from repro_torch.core.accuracy import normalized_vector
from repro_torch.core.cluster import (agree, mesh_max, mesh_ranks,
                                      mesh_structural_key)
from repro_torch.core.motifs.base import (
    DEFAULT_EVAL_BATCH,
    DEFAULT_EVAL_CACHE,
    EVAL_BATCH_BOUNDS,
    EVAL_CACHE_BOUNDS,
    SUBSTRATES,
)
from repro_torch.core.proxy_graph import ProxyBenchmark
from repro_torch.core.signature import (Signature, profile_call, timed_wall,
                                        where_raised)
from repro_torch.core.store import canonical_key, device_key, key_digest
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import use_mesh


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
                 device: DeviceLike = None, store=None, telemetry=None,
                 mesh=None, rules=None):
        self.capacity = _clamp(capacity, EVAL_CACHE_BOUNDS)
        self.device = resolve_device(device)
        self.mesh = mesh
        #: logical-axis rule table programs run under (None = the default
        #: table); a custom table joins the mesh side of the key
        self.rules = rules
        self.mesh_key = mesh_structural_key(mesh)
        if mesh is not None and rules is not None:
            self.mesh_key = self.mesh_key + (
                ("__rules__",) + rules.structural_key(),)
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
        # compile_entry runs in the engine's compile workers
        self._compiles_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def key_for(self, pb: ProxyBenchmark,
                include_repeats: bool = True) -> Tuple:
        """``pb``'s cache key under this cache's cluster scenario: the
        shape signature, plus the mesh's structural key when a mesh is
        bound (the same graph on another mesh is another program)."""
        sig = pb.shape_signature(include_repeats)
        if self.mesh_key is None:
            return sig
        return sig + (self.mesh_key,)

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
        (span ``eval.compile``).  Safe to call from several threads."""
        tel = self.telemetry
        kd = _key_attr(self.key_for(pb)) if tel.enabled else ""
        with tel.span("eval.trace", key=kd):
            vals = pb.lifted_values(self.device)
            fn = pb.build_eval_fn(self.device)
        with tel.span("eval.compile", key=kd):
            # use_mesh is per thread: entered here, in the worker
            with use_mesh(self.mesh, self.rules):
                sig = agree(profile_call(fn, seed, vals, device=self.device),
                            self.mesh)
        with self._compiles_lock:
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


class PopulationEntry:
    """One weight-free shape class's population form: the one-lane runner
    ``fn(seed, lifted, max_reps)``, its ``torch.func.vmap`` over the lanes
    of ``lifted`` (the seed is shared, ``randomness="same"``: every lane
    draws what its candidate's eval form draws), and ``mode``, set by the
    first run: ``{"mode": "vmap"}``, or ``{"mode": "lanes", "reason":
    "<op> at <file:line>"}`` when the vmapped call fails and the lanes
    run one by one."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.vmapped = torch.func.vmap(fn, in_dims=(None, 0),
                                       randomness="same")
        self.mode: Optional[Dict[str, str]] = None

    def runner(self, seed: int, vals: torch.Tensor,
               rows: Sequence[Sequence[Tuple[float, ...]]]
               ) -> Callable[[], Any]:
        """A no-argument call of the whole chunk ``vals`` (lanes x nodes
        x 4, built from ``rows``) in this class's mode, probing the mode
        on the first call."""
        caps = lane_caps(rows)

        def run():
            with no_vmap_fallback():
                return self.vmapped(seed, vals, max_reps=caps)

        if self.mode is None:
            try:
                run()
                self.mode = {"mode": "vmap"}
            except RuntimeError as exc:
                self.mode = {"mode": "lanes", "reason": vmap_reason(exc)}
        if self.mode["mode"] == "vmap":
            return run
        # lane by lane, each at its own repeat counts
        own = [[int(n[0]) for n in r] for r in rows]
        return lambda: [self.fn(seed, vals[j], max_reps=own[j])
                        for j in range(len(rows))]


def lane_caps(rows: Sequence[Sequence[Tuple[float, ...]]]) -> List[int]:
    """Each node's loop length over a chunk's lifted rows (lanes x nodes,
    the repeat count first): the largest repeat count of the lanes."""
    return [int(max(r[i][0] for r in rows)) for i in range(len(rows[0]))]


@dataclass
class PopulationChunk:
    """Up to ``max_batch`` candidates of one weight-free shape class, as
    one population call takes them: the class's ``key`` and ``entry``,
    the ``members``, their lifted ``rows`` and ``vals`` (the rows as a
    lanes x nodes x 4 tensor on the device)."""

    key: Tuple
    entry: PopulationEntry
    members: List[ProxyBenchmark]
    rows: List[List[Tuple[float, ...]]]
    vals: torch.Tensor

    @property
    def caps(self) -> List[int]:
        return lane_caps(self.rows)

    def runner(self, seed: int) -> Callable[[], Any]:
        return self.entry.runner(seed, self.vals, self.rows)


@contextmanager
def no_vmap_fallback():
    """Make an op with no batching rule raise under vmap instead of
    reaching functorch's fallback, which runs it once a lane and only
    warns."""
    functorch = torch._C._functorch
    was = functorch._is_vmap_fallback_enabled()
    functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        functorch._set_vmap_fallback_enabled(was)


_FALLBACK = re.compile(r"(\S+::\S+) hit the vmap fallback")


def vmap_reason(exc: BaseException) -> str:
    """Why a population form could not be vmapped: the op (or the first
    line of the error) and where in this package it was called."""
    text = str(exc).strip()
    found = _FALLBACK.search(text)
    what = found.group(1) if found else (text.splitlines() or [""])[0][:160]
    return f"{what} at {where_raised(exc)}"


class PopulationRegistry:
    """LRU registry of population-form runners (:class:`PopulationEntry`),
    keyed by the weight-free shape class ``shape_signature(False)``; one
    registry is shared across a whole :class:`EvalSession`, so a class
    built for one workload's population serves every later workload."""

    def __init__(self, capacity: int = DEFAULT_EVAL_CACHE):
        self.capacity = _clamp(capacity, EVAL_CACHE_BOUNDS)
        self._fns: "OrderedDict[Tuple, PopulationEntry]" = OrderedDict()
        self.hits = 0
        self.builds = 0

    def __len__(self) -> int:
        return len(self._fns)

    def get_or_build(self, class_key: Tuple,
                     build: Callable[[], PopulationEntry]) -> PopulationEntry:
        entry = self._fns.get(class_key)
        if entry is not None:
            self._fns.move_to_end(class_key)  # LRU, not FIFO
            self.hits += 1
            return entry
        entry = build()
        self._fns[class_key] = entry
        while len(self._fns) > self.capacity:
            self._fns.popitem(last=False)
        self.builds += 1
        return entry

    def stats(self) -> Dict[str, int]:
        return {"pop_hits": self.hits, "pop_builds": self.builds,
                "pop_entries": len(self._fns)}


class BatchEvaluator:
    """Evaluate candidate populations: dedup by shape class, profile once,
    cache.  Callable on one proxy (the tuner's ``EvalFn``) plus an
    ``evaluate_batch`` for whole impact-analysis batches; ``metrics``
    filters the returned vector the way ``proxy_metrics`` does.

    ``compile_workers=None`` (the default) sizes each batch's pool of
    profiling threads to ``min(os.cpu_count(), missing)``; the
    ``REPRO_COMPILE_WORKERS`` environment variable pins it.

    Pass ``cache``/``pop_registry`` to share profiled state across
    evaluators, or use :class:`EvalSession`, which owns both for a whole
    multi-workload run.
    """

    def __init__(self, *, run: bool = True,
                 metrics: Optional[Sequence[str]] = None,
                 seed: int = 0,
                 cache: Optional[ExecutableCache] = None,
                 pop_registry: Optional[PopulationRegistry] = None,
                 capacity: int = DEFAULT_EVAL_CACHE,
                 max_batch: int = DEFAULT_EVAL_BATCH,
                 compile_workers: Optional[int] = None,
                 wall_iters: int = 5,
                 device: DeviceLike = None,
                 mesh=None,
                 rules=None):
        self.run = run
        self.metrics = list(metrics) if metrics is not None else None
        self.seed = seed
        self.cache = (cache if cache is not None
                      else ExecutableCache(capacity, device=device,
                                           mesh=mesh, rules=rules))
        if device is not None and resolve_device(device) != self.cache.device:
            raise ValueError("shared cache was built for another device")
        # equality, not identity: equal meshes partition identically
        if cache is not None and mesh is not None and cache.mesh != mesh:
            raise ValueError(
                "shared cache was built for a different mesh; one engine "
                "serves one cluster scenario")
        # a run=True engine only accepts store entries with measured wall
        # time (and vice versa) — see ExecutableCache._store_lookup
        self.cache.need_wall = self.cache.need_wall or run
        self.pop_registry = (pop_registry if pop_registry is not None
                             else PopulationRegistry(self.cache.capacity))
        self.max_batch = _clamp(max_batch, EVAL_BATCH_BOUNDS)
        if compile_workers is None:
            env = os.environ.get("REPRO_COMPILE_WORKERS")
            # 0 = auto: size each batch's pool to min(cpu_count, missing)
            compile_workers = int(env) if env else 0
        self.compile_workers = max(int(compile_workers), 0)
        self.workers_used = 0
        self.wall_iters = wall_iters
        self.evals = 0

    @property
    def device(self) -> torch.device:
        return self.cache.device

    @property
    def mesh(self):
        return self.cache.mesh

    @property
    def rules(self):
        return self.cache.rules

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
        entries: Dict[Tuple, Optional[CacheEntry]] = {}
        missing: List[Tuple[Tuple, ProxyBenchmark]] = []
        for sk, pb in zip(sig_keys, pbs):
            if sk in entries:
                continue
            entries[sk] = self.cache.lookup(sk)  # None keeps batch order
            if entries[sk] is None:
                missing.append((sk, pb))

        workers = self._effective_workers(len(missing))
        if len(missing) > 1 and workers > 1:
            with ThreadPoolExecutor(workers) as pool:
                built = list(pool.map(
                    lambda item: self.cache.compile_entry(item[1], self.seed),
                    missing))
        else:
            built = [self.cache.compile_entry(pb, self.seed)
                     for _, pb in missing]
        for (sk, _), entry in zip(missing, built):
            entries[sk] = self.cache.insert(sk, entry)

        for entry in entries.values():
            self._finalize(entry)
        return [self._filtered(entries[sk]) for sk in sig_keys]

    def _effective_workers(self, n_missing: int) -> int:
        """Profiling-pool width for one batch: the configured count, or
        ``min(os.cpu_count(), n_missing)`` when auto (0).  The widest
        used is the ``compile_workers_max`` gauge of :meth:`stats`."""
        workers = self.compile_workers or (os.cpu_count() or 1)
        if self.mesh is not None:
            workers = 1  # every rank must issue its collectives in order
        effective = max(min(workers, n_missing), 1)
        if n_missing > 0:
            self.workers_used = max(self.workers_used, effective)
        return effective

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
                          iters=self.wall_iters), \
                    use_mesh(self.mesh, self.rules):
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

    # -- vmapped population execution ---------------------------------------
    def population_runtime(self, pbs: Sequence[ProxyBenchmark],
                           iters: int = 3) -> Dict[str, Any]:
        """Run a whole population through per-class vmapped runners.

        Groups candidates by their weight-free shape class and runs every
        member's (repeats, sparsity, dist_scale, zipf_alpha) row through
        one class's population form, ``max_batch`` lanes a call; the
        runners come from the shared :class:`PopulationRegistry` (a build
        is a "compile").  Each chunk's wall is
        :func:`~repro_torch.core.signature.timed_wall` of its call: one
        captured CUDA graph on the card.  Returns the wall summed over the
        chunks, the class and candidate counts, the builds, ``devices``
        (1: no mesh) and ``modes``: each class's mode by its key digest,
        ``{"mode": "vmap"}`` or ``{"mode": "lanes", "reason": ...}``,
        with how its wall was taken under ``"timing"``.

        With a mesh the lanes split across its ranks: each chunk is
        padded (repeating its last row) to a multiple of the rank count,
        each rank runs its contiguous share of the lanes (no collective
        inside: lanes are independent), and a chunk's wall is the
        slowest rank's; ``devices`` is the rank count."""
        total = 0.0
        builds = self.pop_registry.builds
        modes: Dict[str, Dict[str, Any]] = {}
        classes = set()
        for chunk in self.population_chunks(pbs):
            classes.add(chunk.key)
            wall, timing = timed_wall(chunk.runner(self.seed), iters=iters,
                                      device=self.device)
            total += mesh_max(wall, self.mesh)
            modes[_key_attr(chunk.key)] = {**chunk.entry.mode,
                                           "timing": timing}
        return {"wall_time": total, "classes": len(classes),
                "candidates": len(pbs),
                "compiles": self.pop_registry.builds - builds,
                "devices": len(mesh_ranks(self.mesh)) if self.mesh else 1,
                "modes": modes}

    def lane_share(self, n: int) -> Tuple[int, int]:
        """``(lo, hi)``: the lanes of an ``n``-lane chunk this rank runs,
        and the padded chunk's lane count is a multiple of the mesh's
        rank count (all of ``[0, n)`` without a mesh)."""
        if self.mesh is None:
            return 0, n
        ranks = mesh_ranks(self.mesh)
        per = -(-n // len(ranks))
        i = ranks.index(torch.distributed.get_rank())
        return i * per, (i + 1) * per

    def population_chunks(self, pbs: Sequence[ProxyBenchmark]
                          ) -> Iterator[PopulationChunk]:
        """The chunks :meth:`population_runtime` runs, in its order: the
        candidates grouped by weight-free shape class, each class's
        population form from the shared registry (built at its first
        chunk), at most ``max_batch`` lanes a chunk, since every lane
        holds a full copy of the class's intermediates."""
        groups: "OrderedDict[Tuple, List[ProxyBenchmark]]" = OrderedDict()
        for pb in pbs:
            groups.setdefault(self.cache.key_for(pb, include_repeats=False),
                              []).append(pb)
        dev = self.device
        for class_key, members in groups.items():
            entry = self.pop_registry.get_or_build(
                class_key,
                lambda m=members[0]: PopulationEntry(m.build_lifted_fn(dev)))
            for lo in range(0, len(members), self.max_batch):
                chunk = members[lo:lo + self.max_batch]
                rows = [[n.p.lifted_row() for n in pb.nodes] for pb in chunk]
                if self.mesh is not None:  # this rank's lanes, padded
                    a, b = self.lane_share(len(rows))
                    rows = (rows + [rows[-1]] * (b - len(rows)))[a:b]
                    chunk = (chunk + [chunk[-1]] * (b - len(chunk)))[a:b]
                yield PopulationChunk(
                    class_key, entry, chunk, rows,
                    torch.tensor(rows, dtype=torch.float32, device=dev))

    def stats(self) -> Dict[str, int]:
        s = self.cache.stats()
        s.update(self.pop_registry.stats())
        s["evals"] = self.evals
        # gauge (like "...entries"): the widest compile pool actually used
        s["compile_workers_max"] = self.workers_used
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

    The session owns one :class:`PopulationRegistry` as well, so
    :meth:`population_runtime` reuses population forms across workloads.

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
                 compile_workers: Optional[int] = None,
                 wall_iters: int = 5,
                 priors: bool = False,
                 substrate: str = "torch",
                 store=None,
                 telemetry=None,
                 device: DeviceLike = None,
                 mesh=None,
                 rules=None):
        if substrate not in SUBSTRATES:
            raise ValueError(f"unknown substrate {substrate!r} "
                             f"(have {SUBSTRATES})")
        #: persistent cross-process store; in-memory misses consult it
        #: before profiling and finalized entries write through.  One
        #: store may back sessions on several meshes: the mesh is in the
        #: key
        self.store = store
        self.cache = ExecutableCache(capacity, device=device, store=store,
                                     telemetry=telemetry, mesh=mesh,
                                     rules=rules)
        self.pop_registry = PopulationRegistry(capacity)
        #: default for generate_proxy(..., priors=None) calls routed
        #: through this session
        self.priors = bool(priors)
        #: default for generate_proxy(..., substrate=None) calls; the
        #: knob lives in each node's P (structural in the cache key), so
        #: one session can hold entries for both substrates
        self.substrate = substrate
        self.engine = BatchEvaluator(run=run, seed=seed, cache=self.cache,
                                     pop_registry=self.pop_registry,
                                     max_batch=max_batch,
                                     compile_workers=compile_workers,
                                     wall_iters=wall_iters)
        #: per-workload stats deltas, in sweep order
        self.workload_stats: "OrderedDict[str, Dict[str, int]]" = OrderedDict()
        # one snapshot() on the hub now supersets this session's stats()
        self.telemetry.register_provider("engine", self.stats)

    @property
    def device(self) -> torch.device:
        return self.cache.device

    @property
    def mesh(self):
        """The cluster scenario's mesh this session is pinned to (None:
        the single-device path)."""
        return self.cache.mesh

    @property
    def rules(self):
        return self.cache.rules

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

    def population_runtime(self, pbs: Sequence[ProxyBenchmark],
                           iters: int = 3) -> Dict[str, Any]:
        return self.engine.population_runtime(pbs, iters=iters)

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
