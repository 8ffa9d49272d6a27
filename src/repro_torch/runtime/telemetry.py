"""Unified telemetry: span tracing + typed metrics (port of
``repro/runtime/telemetry.py``).

The engine's knowledge of itself — ``EvalSession.stats()``,
``ProxyStore.stats()``, the tuner's iterations — lands in one hub:

* **Span tracing** — ``with telemetry.span("eval.compile", key=...)``
  records begin/end + attributes on a thread-safe ring buffer, nestable
  per thread (a span opened inside another becomes its child) and
  linkable across threads (``add_span(..., parent=...)`` emits a
  completed span with explicit timestamps).  ``export_trace(path)``
  writes Chrome trace-event JSON loadable in Perfetto or
  ``chrome://tracing``.
* **A typed metrics registry** — ``counter``/``gauge``/``histogram``
  (bounded samples, nearest-rank percentiles).  Re-registering a name as
  a different kind raises: a metric name means one thing.
* **Stats providers** — ``register_provider("engine", session.stats)``,
  so one ``telemetry.snapshot()`` returns the engine and store state next
  to the per-span wall attribution.

The span and event names are the reference's (``SPAN_ATTRS``,
``EVENT_ATTRS``).  In the port the evaluator's ``eval.trace`` span covers
building a proxy's eval-form runner and ``eval.compile`` its one
profiled dispatch run (``signature.profile_call``), the port's
counterpart of an XLA compile; ``eval.execute`` covers the wall-time
measurement.

Disabled by default: the module-level :data:`NULL` hub is a strict
no-op — ``span()`` returns a shared singleton context manager, no lock
is acquired — so instrumented paths cost almost nothing when tracing is
off, and the metrics they compute are bit-identical either way.
Enabling is explicit: ``EvalSession(telemetry=Telemetry())``, or
process-wide through the ``REPRO_TRACE=1`` environment variable
(``get_default()``).
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import OrderedDict, deque
from math import ceil
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

#: bump when the exported trace layout (event fields, args contract)
#: changes; recorded in the exported file's ``metadata`` block.
TRACE_VERSION = 1

#: span kinds -> required attributes, in pipeline order (the reference's
#: table; the ``serve.*`` spans belong to the proxy server).  Every
#: instrumented site emits one of these names with at least the listed
#: attrs; extra attrs are free.
SPAN_ATTRS: "OrderedDict[str, Tuple[str, ...]]" = OrderedDict((
    ("decompose", ("name", "nodes")),
    ("tune.impact", ("candidates",)),
    ("tune.iteration", ("iteration",)),
    ("eval.batch", ("candidates",)),
    ("eval.trace", ("key",)),
    ("eval.compile", ("key",)),
    ("eval.execute", ("key",)),
    ("store.load", ("key",)),
    ("store.save", ("key",)),
    ("serve.batch", ("size",)),
    ("serve.request", ("cls",)),
    ("serve.queue_wait", ()),
    ("serve.batch_assembly", ()),
    ("serve.service", ()),
))

#: the span names alone, in table order
SPAN_KINDS: Tuple[str, ...] = tuple(SPAN_ATTRS)

#: instant-event kinds -> required attributes (zero-duration marks,
#: exported as Chrome ``ph: "i"`` events).
EVENT_ATTRS: "OrderedDict[str, Tuple[str, ...]]" = OrderedDict((
    ("cache.hit", ("key",)),
    ("cache.store_hit", ("key",)),
    ("cache.store_invalid", ("key",)),
))

EVENT_KINDS: Tuple[str, ...] = tuple(EVENT_ATTRS)

#: the registry's metric kinds
METRIC_KINDS = ("counter", "gauge", "histogram")

#: histogram percentiles reported by snapshot() (nearest-rank)
PERCENTILES = (50, 95, 99)

#: ring-buffer capacities: spans beyond the cap drop oldest-first and
#: are counted (snapshot()["spans_dropped"]); histogram samples beyond
#: the cap keep the newest window (per-histogram ``dropped``).
DEFAULT_SPAN_CAPACITY = 1 << 16
DEFAULT_HIST_SAMPLES = 1 << 12

#: snapshot() keys the hub itself owns; provider names may not collide
RESERVED_SECTIONS = ("spans", "events", "counters", "gauges",
                     "histograms", "spans_dropped", "enabled")


def _nearest_rank(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample list (the
    ``ceil(q/100 * n)``-th smallest)."""
    if not sorted_vals:
        return 0.0
    rank = max(1, ceil(q / 100.0 * len(sorted_vals)))
    return float(sorted_vals[min(rank, len(sorted_vals)) - 1])


# ---------------------------------------------------------------------------
# the null hub (disabled path)
# ---------------------------------------------------------------------------


class _NullSpan:
    """The shared no-op span: context manager + attr sink, zero state."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class _NullMetric:
    """No-op counter/gauge/histogram, shared across all names."""

    __slots__ = ()
    value = 0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


NULL_METRIC = _NullMetric()


class NullTelemetry:
    """The disabled hub: every call is a strict no-op.

    No lock is ever acquired, ``span()`` returns the module-singleton
    :data:`NULL_SPAN`, the metric accessors return a shared no-op
    metric, ``snapshot()`` is ``{}`` and ``export_trace`` writes
    nothing (returns ``None``).  Instrumented code holds a reference to
    either this or a real :class:`Telemetry` and never branches —
    except to skip *attribute computation* (e.g. key digests) behind
    ``if telemetry.enabled``.
    """

    enabled = False

    def span(self, name: str, /, **attrs) -> _NullSpan:
        return NULL_SPAN

    def add_span(self, name: str, t0: float, t1: float, /,
                 parent: Optional[int] = None, **attrs) -> Optional[int]:
        return None

    def event(self, name: str, /, **attrs) -> None:
        return None

    def counter(self, name: str) -> _NullMetric:
        return NULL_METRIC

    def gauge(self, name: str) -> _NullMetric:
        return NULL_METRIC

    def histogram(self, name: str) -> _NullMetric:
        return NULL_METRIC

    def register_provider(self, name: str,
                          fn: Callable[[], Dict[str, Any]]) -> None:
        return None

    def snapshot(self) -> Dict[str, Any]:
        return {}

    def export_trace(self, path: str) -> Optional[int]:
        return None


#: the process-wide disabled hub — the default everywhere
NULL = NullTelemetry()


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic counter."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins value."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Bounded sample histogram with nearest-rank percentiles.

    Keeps the newest ``max_samples`` observations (a ring); ``count``
    and ``sum`` stay exact over the full stream, percentiles/mean are
    over the retained window, and ``dropped`` counts what the window
    shed.
    """

    kind = "histogram"

    def __init__(self, name: str, max_samples: int = DEFAULT_HIST_SAMPLES):
        self.name = name
        self._lock = threading.Lock()
        self._samples: "deque[float]" = deque(maxlen=max(1, int(max_samples)))
        self.count = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        with self._lock:
            self._samples.append(float(v))
            self.count += 1
            self.total += float(v)

    @property
    def dropped(self) -> int:
        return self.count - len(self._samples)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            window = sorted(self._samples)
            count, total = self.count, self.total
        out: Dict[str, float] = {
            "count": count,
            "sum": total,
            "mean": (sum(window) / len(window)) if window else 0.0,
            "dropped": count - len(window),
        }
        for q in PERCENTILES:
            out[f"p{q}"] = _nearest_rank(window, q)
        return out


_METRIC_CLASSES = {"counter": Counter, "gauge": Gauge,
                   "histogram": Histogram}
assert tuple(_METRIC_CLASSES) == METRIC_KINDS


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


# A finished span or event sits in the ring buffer as a plain tuple, the
# cheapest record to build on the emitting thread: (name, t0, t1, tid,
# span_id, parent_id, attrs, ph).


class SpanHandle:
    """A live span: context manager that records on exit.

    ``set(**attrs)`` merges attributes at any point before exit — how
    end-of-block facts (accepted moves, miss counts) land on a span
    opened at block entry.  Nesting is per thread: a span entered while
    another is open on the same thread becomes its child.
    """

    __slots__ = ("hub", "name", "attrs", "t0", "span_id", "parent_id")

    def __init__(self, hub: "Telemetry", name: str, attrs: Dict[str, Any]):
        self.hub = hub
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.span_id = 0
        self.parent_id: Optional[int] = None

    def set(self, **attrs) -> "SpanHandle":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "SpanHandle":
        self.span_id = self.hub._new_id()
        stack = self.hub._stack()
        self.parent_id = stack[-1] if stack else None
        stack.append(self.span_id)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        stack = self.hub._stack()
        if stack and stack[-1] == self.span_id:
            stack.pop()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.hub._commit((self.name, self.t0, t1, threading.get_ident(),
                          self.span_id, self.parent_id, self.attrs, "X"))
        return False


class Telemetry:
    """The enabled hub: span ring buffer + typed metrics + providers.

    Thread-safe throughout: spans commit under one lock into a bounded
    ``deque`` (oldest dropped first, counted), metrics carry their own
    locks, and the per-thread span stack lives in a ``threading.local``
    so concurrent emitters never see each other's nesting.
    """

    enabled = True

    def __init__(self, span_capacity: int = DEFAULT_SPAN_CAPACITY,
                 hist_samples: int = DEFAULT_HIST_SAMPLES):
        self._lock = threading.Lock()
        self._records: "deque[tuple]" = deque(
            maxlen=max(1, int(span_capacity)))
        self._committed = 0
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._thread_names: Dict[int, str] = {}
        self._metrics: Dict[str, Any] = {}
        self._providers: "OrderedDict[str, Callable[[], Dict]]" = OrderedDict()
        self.hist_samples = max(1, int(hist_samples))
        #: perf_counter at construction — exported timestamps are
        #: microseconds since this epoch, so traces start near 0
        self.t_epoch = time.perf_counter()

    # -- span plumbing -------------------------------------------------------
    def _new_id(self) -> int:
        return next(self._ids)  # CPython-atomic

    def _stack(self) -> List[int]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _commit(self, rec: tuple) -> None:
        tid = rec[3]
        with self._lock:
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            self._records.append(rec)
            self._committed += 1

    @property
    def spans_dropped(self) -> int:
        with self._lock:
            return self._committed - len(self._records)

    # -- the public emission surface -----------------------------------------
    def span(self, name: str, /, **attrs) -> SpanHandle:
        """A context-managed span: ``with hub.span("eval.compile",
        key=digest) as sp: ...; sp.set(more=...)``."""
        return SpanHandle(self, name, attrs)

    def add_span(self, name: str, t0: float, t1: float, /,
                 parent: Optional[int] = None, **attrs) -> int:
        """Record an already-finished span with explicit ``perf_counter``
        timestamps; returns its span id (usable as ``parent`` for
        children).  This is the cross-thread path: the recording thread
        need not be the one the time was spent on."""
        sid = next(self._ids)
        self._commit((name, float(t0), float(t1), threading.get_ident(), sid,
                      parent, attrs, "X"))
        return sid

    def event(self, name: str, /, **attrs) -> None:
        """A zero-duration instant mark (cache hits, invalidations)."""
        t = time.perf_counter()
        stack = getattr(self._tls, "stack", None)
        self._commit((name, t, t, threading.get_ident(), next(self._ids),
                      stack[-1] if stack else None, attrs, "i"))

    # -- the metrics registry ------------------------------------------------
    def _metric(self, name: str, kind: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind:
                    raise TypeError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"not {kind}")
                return m
            if kind == "histogram":
                m = Histogram(name, self.hist_samples)
            else:
                m = _METRIC_CLASSES[kind](name)
            self._metrics[name] = m
            return m

    def counter(self, name: str) -> Counter:
        return self._metric(name, "counter")

    def gauge(self, name: str) -> Gauge:
        return self._metric(name, "gauge")

    def histogram(self, name: str) -> Histogram:
        return self._metric(name, "histogram")

    # -- providers -----------------------------------------------------------
    def register_provider(self, name: str,
                          fn: Callable[[], Dict[str, Any]]) -> None:
        """Attach a stats callable (``EvalSession.stats``, ...) whose
        latest result is inlined into ``snapshot()`` under ``name``.
        Re-registering a name replaces the callable; hub-owned section
        names are reserved."""
        if name in RESERVED_SECTIONS:
            raise ValueError(f"provider name {name!r} is reserved")
        with self._lock:
            self._providers[name] = fn

    # -- aggregation ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The full observable state, one dict: per-span-name wall
        attribution, event counts, every registered metric, and every
        provider's current ``stats()``/``metrics()`` output."""
        with self._lock:
            records = list(self._records)
            metrics = dict(self._metrics)
            providers = list(self._providers.items())
            dropped = self._committed - len(self._records)
        spans: Dict[str, Dict[str, float]] = {}
        events: Dict[str, int] = {}
        for name, t0, t1, _, _, _, _, ph in records:
            if ph == "i":
                events[name] = events.get(name, 0) + 1
                continue
            agg = spans.setdefault(name, {"count": 0, "wall_s": 0.0,
                                          "max_s": 0.0})
            dur = max(t1 - t0, 0.0)
            agg["count"] += 1
            agg["wall_s"] += dur
            agg["max_s"] = max(agg["max_s"], dur)
        out: Dict[str, Any] = {
            "enabled": True,
            "spans": spans,
            "events": events,
            "counters": {n: m.value for n, m in metrics.items()
                         if m.kind == "counter"},
            "gauges": {n: m.value for n, m in metrics.items()
                       if m.kind == "gauge"},
            "histograms": {n: m.summary() for n, m in metrics.items()
                           if m.kind == "histogram"},
            "spans_dropped": dropped,
        }
        for name, fn in providers:
            try:
                out[name] = fn()
            except Exception as e:  # noqa: BLE001 — a dead provider may
                out[name] = {"provider_error": repr(e)}  # not kill snapshot
        return out

    # -- export --------------------------------------------------------------
    def trace_events(self) -> List[Dict[str, Any]]:
        """The Chrome trace-event list (the ``traceEvents`` value):
        one ``ph: "X"`` complete event per span (``ts``/``dur`` in
        microseconds since the hub epoch), ``ph: "i"`` instants for
        events, and ``ph: "M"`` thread-name metadata."""
        with self._lock:
            records = list(self._records)
            tnames = dict(self._thread_names)
        pid = os.getpid()
        events: List[Dict[str, Any]] = []
        for tid, tname in sorted(tnames.items()):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": tname}})
        for name, t0, t1, tid, span_id, parent_id, attrs, ph in records:
            args = dict(attrs)
            args["id"] = span_id
            if parent_id is not None:
                args["parent"] = parent_id
            ev: Dict[str, Any] = {
                "name": name, "cat": "repro_torch", "ph": ph, "pid": pid,
                "tid": tid, "ts": (t0 - self.t_epoch) * 1e6, "args": args,
            }
            if ph == "X":
                ev["dur"] = max(t1 - t0, 0.0) * 1e6
            else:
                ev["s"] = "t"
            events.append(ev)
        return events

    def export_trace(self, path: str) -> int:
        """Write the Chrome trace JSON (Perfetto-loadable) to ``path``
        atomically; returns the number of trace events written.  The
        document is ``{"traceEvents": [...], "displayTimeUnit": "ms",
        "metadata": {...}}`` with strict JSON (no NaN/Infinity)."""
        from repro_torch.core.store import atomic_write_text

        events = self.trace_events()
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {"trace_version": TRACE_VERSION,
                         "exporter": "repro_torch.runtime.telemetry",
                         "spans_dropped": self.spans_dropped},
        }
        atomic_write_text(path, json.dumps(doc, default=str,
                                           allow_nan=False))
        return len(events)


# ---------------------------------------------------------------------------
# the process default (REPRO_TRACE)
# ---------------------------------------------------------------------------


def _env_enabled() -> bool:
    return os.environ.get("REPRO_TRACE", "").strip().lower() not in (
        "", "0", "false", "no")


#: resolved once at import: a live hub when REPRO_TRACE=1, else NULL
_default: Any = Telemetry() if _env_enabled() else NULL


def get_default():
    """The process-wide hub: :data:`NULL` unless ``REPRO_TRACE=1`` was
    set at import (or :func:`set_default` installed a hub).  Every
    ``telemetry=None`` entry point (``EvalSession``, ``BatchEvaluator``,
    ``decompose``, ...) resolves through here."""
    return _default


def set_default(hub) -> Any:
    """Install ``hub`` as the process default; returns the previous one
    (pass :data:`NULL` to disable)."""
    global _default
    prev = _default
    _default = hub if hub is not None else NULL
    return prev
