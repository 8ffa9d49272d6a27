"""Proxy-generation-as-a-service: a long-running session server (port of
``repro/runtime/proxy_server.py``).

One :class:`ProxyServer` owns one shared
:class:`~repro_torch.core.evaluator.EvalSession` (optionally store-backed,
so the whole service warm-starts across processes) and accepts concurrent
**tune** / **evaluate** / **signature** requests over a thread-safe queue.
Compatible evaluate requests that are queued together are coalesced into
one :meth:`EvalSession.evaluate_batch` call: the engine's dedup and
profile-once cache is the batching engine, so a burst of candidates costs
one profile per shape class, not one per request.

Correctness model: ONE dispatcher thread drains the queue, so every
request is executed serially through the shared session.  Results are
therefore bit-identical to running the same requests serially through one
``EvalSession`` in any order: a shape class's metrics are profiled once
and then served from the cache or the store, whatever the order.  A
request that raises inside the worker fails only its own future: a batch
that throws is retried one request at a time so one poisoned proxy cannot
fail its batch-mates.  Only Python exceptions are isolated; a CUDA fault
is sticky and poisons the whole context.

On the card, the dispatcher thread runs every profile, and a profile's
``peak_memory`` is the CUDA allocator's peak over the run
(``core/signature.py::profile_call``), which is kept per device, not per
thread.  So a client must build every CUDA input (a tune's workload
arguments included) before it submits, and allocate nothing on the card
while requests are in flight: an allocation on another thread during a
profile would change the metric.  Thread-local state (grad mode,
``inference_mode``, dispatch modes, the current CUDA stream) does not
follow a request into the dispatcher, which runs with the defaults of a
new thread.  Read the kernels' launch counters only after
:meth:`ProxyServer.shutdown` has joined the dispatcher.

Metric discipline: per request class the server reports count,
**P50/P95/P99 latency** (nearest-rank percentiles over submit->result
latencies, queue wait included) and **time-to-first-result** (first
result's completion minus that class's first submission), plus the
engine's cache and store hit/miss counters.
``repro_torch.bench.serve_bench`` drives open- and closed-loop load
against this surface and gates the tail.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from math import ceil
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.evaluator import EvalSession
from repro_torch.core.motifs.base import DEFAULT_EVAL_BATCH
from repro_torch.runtime.telemetry import get_default

#: the request classes, in dispatch order (the reference's
#: docs/SERVING.md request-class table)
REQUEST_CLASSES = ("evaluate", "signature", "tune")

#: reported latency percentiles (nearest-rank)
PERCENTILES = (50, 95, 99)

#: per-class latency sample retention (ring): percentiles are computed
#: over the newest this-many samples; older ones are shed and counted
#: (``samples_dropped``), bounding recorder memory under open-loop load.
DEFAULT_LATENCY_SAMPLES = 4096


def percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the ceil(q/100 * n)-th smallest value, so
    a reported P99 is always a latency that actually occurred."""
    if not sorted_vals:
        return 0.0
    rank = max(1, ceil(q / 100.0 * len(sorted_vals)))
    return float(sorted_vals[min(rank, len(sorted_vals)) - 1])


class LatencyRecorder:
    """Per-class latency samples + time-to-first-result, thread-safe.

    Memory is bounded: each class keeps a ring of the newest
    ``max_samples`` latencies (``DEFAULT_LATENCY_SAMPLES``), so an
    open-loop run of any length holds a fixed window.  ``count`` stays
    the exact number of completed results; percentiles/mean are
    nearest-rank over the retained window; ``samples_dropped`` counts
    what the ring shed (0 until the cap is hit).
    """

    def __init__(self, max_samples: int = DEFAULT_LATENCY_SAMPLES) -> None:
        self._lock = threading.Lock()
        self.max_samples = max(1, int(max_samples))
        self._samples: Dict[str, "deque[float]"] = {}
        self._counts: Dict[str, int] = {}
        self._first_submit: Dict[str, float] = {}
        self._first_result: Dict[str, float] = {}

    def on_submit(self, cls: str, t: float) -> None:
        with self._lock:
            self._first_submit.setdefault(cls, t)

    def on_result(self, cls: str, t_submit: float, t_done: float) -> None:
        with self._lock:
            dq = self._samples.get(cls)
            if dq is None:
                dq = self._samples[cls] = deque(maxlen=self.max_samples)
            dq.append(t_done - t_submit)
            self._counts[cls] = self._counts.get(cls, 0) + 1
            self._first_result.setdefault(cls, t_done)

    def summary(self) -> Dict[str, Dict[str, Any]]:
        """``{class: {count, p50_s, p95_s, p99_s, mean_s, ttfr_s,
        samples_dropped}}`` for every class that has seen at least one
        submission.  ``ttfr_s`` is ``None`` (strict-JSON ``null``, not
        NaN) for a class with a submission but no completed result yet."""
        with self._lock:
            out: Dict[str, Dict[str, Any]] = {}
            for cls, t0 in self._first_submit.items():
                lat = sorted(self._samples.get(cls, ()))
                count = self._counts.get(cls, 0)
                row: Dict[str, Any] = {"count": count}
                for q in PERCENTILES:
                    row[f"p{q}_s"] = percentile(lat, q)
                row["mean_s"] = (sum(lat) / len(lat)) if lat else 0.0
                row["samples_dropped"] = count - len(lat)
                t1 = self._first_result.get(cls)
                row["ttfr_s"] = (t1 - t0) if t1 is not None else None
                out[cls] = row
            return out


@dataclass
class _Request:
    kind: str
    payload: Any
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.perf_counter)
    #: when the dispatcher popped this request off the queue (queue wait
    #: ends) and when its service actually began (batch fully assembled):
    #: the serve.request span's child boundaries
    t_dispatch: Optional[float] = None
    t_ready: Optional[float] = None


_STOP = object()


class ServerClosed(RuntimeError):
    pass


class ProxyServer:
    """Concurrent tune/evaluate front-end over one shared
    :class:`EvalSession`.

    ::

        with ProxyServer(EvalSession(run=False, store=store)) as srv:
            futs = [srv.submit_evaluate(pb) for pb in candidates]
            rep = srv.submit_tune(step_fn, x, name="w", max_iters=4)
            metrics = [f.result() for f in futs]
        print(srv.metrics()["classes"]["evaluate"]["p99_s"])

    ``max_batch`` bounds evaluate-coalescing (default: the session
    engine's ``max_batch``, else ``DEFAULT_EVAL_BATCH``).  Requests
    submitted before :meth:`start` buffer in the queue and run once the
    dispatcher is up: submitting a burst first maximises coalescing.
    ``shutdown(drain=True)`` (the context-manager exit) completes every
    queued request before stopping; ``drain=False`` cancels what has not
    started.  A server is not restarted after shutdown: construct a new
    one over the same session.
    """

    def __init__(self, session: EvalSession, *,
                 max_batch: Optional[int] = None,
                 telemetry=None,
                 max_latency_samples: int = DEFAULT_LATENCY_SAMPLES):
        self.session = session
        if max_batch is None:
            max_batch = getattr(getattr(session, "engine", None),
                                "max_batch", DEFAULT_EVAL_BATCH)
        self.max_batch = max(1, int(max_batch))
        #: telemetry hub: per-request serve.request spans with
        #: queue_wait/batch_assembly/service children linked to the
        #: coalesced serve.batch span.  Defaults to the session's hub so
        #: serve spans interleave with the engine's eval/store spans.
        if telemetry is None:
            telemetry = getattr(session, "telemetry", None)
        self.telemetry = telemetry if telemetry is not None else get_default()
        # one snapshot() now supersets this server's metrics() too
        self.telemetry.register_provider("server", self.metrics)
        self.recorder = LatencyRecorder(max_latency_samples)
        self._q: "queue.Queue[Any]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._closed = False
        self._draining = True
        self.t_start: Optional[float] = None
        # batching counters: how much coalescing actually happened
        self.batches = 0
        self.batched_requests = 0
        self.max_batch_used = 0
        self.errors = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ProxyServer":
        if self._thread is not None:
            return self
        self.t_start = time.perf_counter()
        self._thread = threading.Thread(target=self._serve,
                                        name="proxy-server", daemon=True)
        self._thread.start()
        return self

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None
                 ) -> None:
        """Stop the dispatcher.  ``drain=True`` processes every request
        already queued first; ``drain=False`` cancels them."""
        with self._lock:
            if self._closed:
                if self._thread is not None:
                    self._thread.join(timeout)
                return
            self._closed = True
            self._draining = drain
        self._q.put(_STOP)
        if self._thread is not None:
            self._thread.join(timeout)

    def __enter__(self) -> "ProxyServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=True)

    # -- submission ----------------------------------------------------------
    def _submit(self, kind: str, payload: Any) -> Future:
        if kind not in REQUEST_CLASSES:
            raise ValueError(f"unknown request class {kind!r}; "
                             f"have {REQUEST_CLASSES}")
        with self._lock:
            if self._closed:
                raise ServerClosed("server is shut down")
        req = _Request(kind, payload)
        self.recorder.on_submit(kind, req.t_submit)
        self._q.put(req)
        return req.future

    def submit_evaluate(self, pb) -> Future:
        """Metric vector of one candidate proxy (a ``ProxyBenchmark``);
        resolves to ``Dict[str, float]``."""
        return self._submit("evaluate", pb)

    def submit_signature(self, pb) -> Future:
        """Full :class:`~repro_torch.core.signature.Signature` of one
        proxy; reuses cached and stored profiles like every engine path."""
        return self._submit("signature", pb)

    def submit_tune(self, workload_fn: Callable, *args,
                    **generate_kwargs) -> Future:
        """Full ``generate_proxy`` run through the shared session;
        resolves to ``(ProxyBenchmark, ProxyReport)``.  Keyword args are
        forwarded (``name=``, ``max_iters=``, ``hints=``, ...); ``run``,
        ``seed`` and ``device`` default to the session's, and its priors
        and substrate defaults apply exactly as for a direct
        ``generate_proxy(..., session=...)`` call.  The arguments must
        already lie on the session's device."""
        return self._submit("tune", (workload_fn, args, generate_kwargs))

    # -- the dispatcher ------------------------------------------------------
    def _serve(self) -> None:
        pending: Optional[_Request] = None
        while True:
            item = pending if pending is not None else self._q.get()
            pending = None
            if item is _STOP:
                break
            if item.t_dispatch is None:
                item.t_dispatch = time.perf_counter()
            batch = [item]
            if item.kind == "evaluate":
                # coalesce the evaluate requests already queued (up to
                # max_batch); the first non-evaluate (or _STOP) is held
                # over to the next loop turn: FIFO order is preserved
                # within a class and metric values are order-independent
                while len(batch) < self.max_batch:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is not _STOP and nxt.t_dispatch is None:
                        nxt.t_dispatch = time.perf_counter()
                    if nxt is _STOP or nxt.kind != "evaluate":
                        pending = nxt
                        break
                    batch.append(nxt)
                self._run_evaluate_batch(batch)
            else:
                self._run_one(item)
            if pending is _STOP:
                break
        # drained shutdown processed everything before _STOP; a
        # non-draining shutdown cancels whatever is still queued
        while True:
            try:
                left = self._q.get_nowait()
            except queue.Empty:
                break
            if left is _STOP:
                continue
            if left.t_dispatch is None:
                left.t_dispatch = time.perf_counter()
            if self._draining:
                if left.kind == "evaluate":
                    self._run_evaluate_batch([left])
                else:
                    self._run_one(left)
            else:
                left.future.cancel()

    def _emit_request_spans(self, req: _Request, t_done: float,
                            batch_id: Optional[int] = None,
                            error: Optional[str] = None) -> None:
        """Retroactive per-request trace spans: ``serve.request`` [submit
        -> done] with three children whose durations sum EXACTLY to the
        recorded request latency: ``serve.queue_wait`` [submit ->
        dispatch], ``serve.batch_assembly`` [dispatch -> ready] and
        ``serve.service`` [ready -> done].  ``batch_id`` links coalesced
        requests to their ``serve.batch`` span.  Recorded via ``add_span``
        (explicit timestamps) because the boundaries were stamped on
        submitter and dispatcher threads."""
        tel = self.telemetry
        if not tel.enabled:
            return
        t0 = req.t_submit
        td = req.t_dispatch if req.t_dispatch is not None else t0
        tr = req.t_ready if req.t_ready is not None else td
        attrs: Dict[str, Any] = {"cls": req.kind}
        if batch_id is not None:
            attrs["batch"] = batch_id
        if error is not None:
            attrs["error"] = error
        rid = tel.add_span("serve.request", t0, t_done, **attrs)
        tel.add_span("serve.queue_wait", t0, td, parent=rid)
        tel.add_span("serve.batch_assembly", td, tr, parent=rid)
        tel.add_span("serve.service", tr, t_done, parent=rid)

    def _run_evaluate_batch(self, batch: List[_Request]) -> None:
        self.batches += 1
        self.batched_requests += len(batch)
        self.max_batch_used = max(self.max_batch_used, len(batch))
        if len(batch) > 1:
            t_ready = time.perf_counter()
            for r in batch:
                r.t_ready = t_ready
            try:
                results = self.session.evaluate_batch(
                    [r.payload for r in batch])
            except Exception:  # noqa: BLE001 — isolate batch failure:
                # one poisoned proxy must fail only its own future:
                # degrade to per-request execution
                for r in batch:
                    self._run_one(r)
                return
            t_done = time.perf_counter()
            batch_id = None
            if self.telemetry.enabled:
                batch_id = self.telemetry.add_span(
                    "serve.batch", t_ready, t_done, size=len(batch))
            for r, m in zip(batch, results):
                r.future.set_result(m)
                self.recorder.on_result(r.kind, r.t_submit, t_done)
                self._emit_request_spans(r, t_done, batch_id=batch_id)
            return
        self._run_one(batch[0])

    def _run_one(self, req: _Request) -> None:
        req.t_ready = time.perf_counter()
        try:
            if req.kind == "evaluate":
                result = self.session.evaluate(req.payload)
            elif req.kind == "signature":
                result = self.session.signature_of(req.payload)
            else:  # tune
                from repro_torch.core.generator import generate_proxy

                fn, args, kwargs = req.payload
                # generate_proxy refuses a shared evaluator whose run,
                # seed or device disagree with the call: default all
                # three to the session's so plain submit_tune() works
                kwargs.setdefault("run", self.session.run)
                kwargs.setdefault("seed", self.session.seed)
                kwargs.setdefault("device", self.session.device)
                result = generate_proxy(fn, *args, session=self.session,
                                        **kwargs)
        except BaseException as e:  # noqa: BLE001 — isolate per request
            self.errors += 1
            req.future.set_exception(e)
            self._emit_request_spans(req, time.perf_counter(),
                                     error=type(e).__name__)
            return
        req.future.set_result(result)
        t_done = time.perf_counter()
        self.recorder.on_result(req.kind, req.t_submit, t_done)
        self._emit_request_spans(req, t_done)

    # -- metrics -------------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        """The serving scorecard: per-class latency percentiles + TTFR,
        batching counters, and the shared engine's cache/store stats
        (``store_hits``/``store_misses``/... when the session is
        store-backed)."""
        classes = self.recorder.summary()
        mean_batch = (self.batched_requests / self.batches
                      if self.batches else 0.0)
        return {
            "classes": classes,
            "requests": sum(int(c["count"]) for c in classes.values()),
            "errors": self.errors,
            "batches": {"count": self.batches,
                        "requests": self.batched_requests,
                        "mean_size": mean_batch,
                        "max_size": self.max_batch_used},
            "engine": self.session.stats(),
            "uptime_s": (time.perf_counter() - self.t_start
                         if self.t_start is not None else 0.0),
        }
