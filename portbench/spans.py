"""What the program's run spans show in a traced run: the device time each
phase of a proxy run launched, the device's idle gaps by the innermost
span open on the host, and the parts of set-up.

While ``torch.profiler`` records, a live span of the program's telemetry
hub (``repro_torch.runtime.telemetry``) is also a ``record_function``
range of its name: a ``user_annotation`` event of the profiler's trace,
on the profiler's clock.  A device operation belongs to the ranges open
on the thread that launched it when it was launched: its CUDA runtime or
driver call carries the same ``correlation`` as the operation.  The set-up
parts are read from the hub's own spans (``Telemetry.trace_events``).

The readers ``metrics/<name>.py`` of :data:`METRICS` read a run's
:class:`RunSpans` (``run.spans``); no metric of ``BENCHMARK.json`` lists
them yet, since the harness does not take the spans (``PERF.md`` §7), and
``tools/spans.py`` reports them for one cell.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import Counter
from dataclasses import dataclass
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

import torch

from portbench.devtrace import DEVICE_CATS, LOOK_BACK, _profile, merged

#: the phases of a node in the runner, which together cover an eager run
PHASES = ("proxy.inputs", "proxy.forward", "proxy.apply")
#: the host calls that launch device operations
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "no span"
#: the metrics read from a run's spans, one reader each under ``metrics/``
METRICS = ("inputs_ms", "forward_ms", "apply_ms", "setup_kernels_s",
           "setup_graph_s")


@dataclass
class RunSpans:
    """What a run's spans give its readers: device ms a run by phase
    (every phase of :data:`PHASES`, 0 where it launched nothing), and
    seconds of set-up by part (:func:`setup_parts`)."""

    phase_ms: Dict[str, float]
    setup_s: Dict[str, float]


def read_phase(run, phase: str) -> Optional[float]:
    """``run.spans``' device ms a run of ``phase``; None without spans."""
    sp = getattr(run, "spans", None)
    return None if sp is None else sp.phase_ms[phase]


def read_setup(run, part: str) -> Optional[float]:
    """``run.spans``' seconds of set-up part ``part``; None without spans
    or without a span of that part."""
    sp = getattr(run, "spans", None)
    return None if sp is None else sp.setup_s.get(part)


class PhasesMissed(RuntimeError):
    """A profiled eager run launched a device operation outside every
    phase range (``PHASES``): the phases do not cover the run."""


@dataclass
class SpanTrace:
    """A profiled part: device operations with the host call that launched
    each, and the program's spans as the profiler's ranges."""

    #: (name, category, start us, duration us, correlation), by start
    device: List[Tuple[str, str, float, float, int]]
    #: correlation -> (thread, start us) of the host call that launched it
    launches: Dict[int, Tuple[int, float]]
    #: (name, thread, start us, end us), by start
    ranges: List[Tuple[str, int, float, float]]

    def __post_init__(self):
        self._starts = [r[2] for r in self.ranges]

    def range_at(self, t: float, tid: Optional[int] = None,
                 names: Optional[Iterable[str]] = None) -> Optional[int]:
        """Index of the innermost range open at ``t`` (on thread ``tid``,
        of the ``names``, where given): of those covering it, the one that
        began last.  Looks back over at most ``LOOK_BACK`` ranges."""
        names = None if names is None else set(names)
        i = bisect.bisect_right(self._starts, t)
        for j in range(i - 1, max(i - LOOK_BACK, 0) - 1, -1):
            name, rtid, ts, end = self.ranges[j]
            if (end > t and (tid is None or rtid == tid)
                    and (names is None or name in names)):
                return j
        return None


def read_trace(events: Sequence[Mapping]) -> SpanTrace:
    """A :class:`SpanTrace` from the profiler's exported trace events."""
    device, launches, ranges = [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, args = ev.get("cat"), ev.get("args") or {}
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((str(ev.get("name")), cat, ts, dur,
                           int(args.get("correlation", -1))))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[int(args["correlation"])] = (ev.get("tid"), ts)
        elif cat == "user_annotation":
            ranges.append((str(ev.get("name")), ev.get("tid"), ts, ts + dur))
    device.sort(key=lambda e: e[2])
    ranges.sort(key=lambda r: r[2])
    return SpanTrace(device, launches, ranges)


def profile(work: Callable[[], None], device: torch.device) -> SpanTrace:
    """Profile ``work`` with the host's and the card's activity and read
    back its exported trace."""
    cuda = device.type == "cuda"
    with _profile(cuda, False) as prof:
        work()
        if cuda:
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(prefix="portbench-spans-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return read_trace(json.load(f)["traceEvents"])
    finally:
        os.unlink(path)


def phase_of_ops(tr: SpanTrace) -> List[int]:
    """For each device operation, the index of the phase range its launch
    fell in.  Raises :class:`PhasesMissed` for one outside every phase."""
    out, missed = [], []
    for name, _, ts, _, corr in tr.device:
        tid, t = tr.launches.get(corr, (None, None))
        j = None if t is None else tr.range_at(t, tid, PHASES)
        if j is None:
            missed.append(name)
        out.append(j)
    if missed:
        raise PhasesMissed(
            f"{len(missed)} of {len(tr.device)} device operations were "
            f"launched outside every phase range {PHASES}, first "
            f"{missed[:3]}: a span of the runner is missing or renamed")
    return out


def run_spans(eager: SpanTrace, runs: int,
              setup_events: Sequence[Mapping]) -> RunSpans:
    """The readers' :class:`RunSpans` of ``runs`` profiled eager runs and
    the spans the hub committed during set-up."""
    phases = dict.fromkeys(PHASES, 0.0)
    phases.update(phase_device_ms(eager, runs))
    return RunSpans(phases, setup_parts(setup_events))


def label_ranges(tr: SpanTrace, hub_events: Sequence[Mapping]
                 ) -> List[str]:
    """Each range's name and, for a span with a ``node``, the node
    (``proxy.apply n0_matrix``): the k-th range of a name is the hub's
    k-th span of that name, in the order they began."""
    by_name: Dict[str, List[Mapping]] = {}
    for ev in sorted((e for e in hub_events if e.get("ph") == "X"),
                     key=lambda e: e["ts"]):
        by_name.setdefault(ev["name"], []).append(ev)
    counts = Counter(name for name, _, _, _ in tr.ranges)
    for name, spans in by_name.items():
        if len(spans) != counts[name]:
            raise ValueError(f"{len(spans)} hub spans {name!r} against "
                             f"{counts[name]} profiler ranges")
    seen: Counter = Counter()
    labels = []
    for name, _, _, _ in tr.ranges:
        node = None
        if name in by_name:
            node = by_name[name][seen[name]]["args"].get("node")
            seen[name] += 1
        labels.append(name if node is None else f"{name} {node}")
    return labels


def phase_device_ms(tr: SpanTrace, runs: int,
                    labels: Optional[List[str]] = None
                    ) -> Dict[str, float]:
    """Device ms a run of the operations each phase launched (by phase, or
    by ``labels`` of the ranges where given); every operation has to fall
    in a phase (:func:`phase_of_ops`)."""
    out: Dict[str, float] = {}
    for (_, _, _, dur, _), j in zip(tr.device, phase_of_ops(tr)):
        key = tr.ranges[j][0] if labels is None else labels[j]
        out[key] = out.get(key, 0.0) + dur * 1e-3 / runs
    return out


def idle_gaps(tr: SpanTrace, labels: Optional[List[str]] = None
              ) -> Dict[str, float]:
    """Seconds the device idled between its operations, by the innermost
    range open on the host when each gap began (its name, or its label
    where given; ``NO_SPAN`` outside every range)."""
    spans = merged([(ts, ts + dur) for _, _, ts, dur, _ in tr.device])
    gaps: Dict[str, float] = {}
    for (_, end), (start, _) in zip(spans, spans[1:]):
        if start > end:
            j = tr.range_at(end)
            key = (NO_SPAN if j is None else
                   tr.ranges[j][0] if labels is None else labels[j])
            gaps[key] = gaps.get(key, 0.0) + (start - end) * 1e-6
    return gaps


def busy_s(tr: SpanTrace) -> float:
    """Seconds the device was busy: the union of its operations."""
    return 1e-6 * sum(e - s for s, e in merged(
        [(ts, ts + dur) for _, _, ts, dur, _ in tr.device]))


def setup_parts(hub_events: Sequence[Mapping]) -> Dict[str, float]:
    """Seconds of set-up by part, from the hub's spans: ``kernels`` (every
    ``kernels.load``) and ``graph`` (every ``graph.setup`` less the
    ``kernels.load`` spans inside it).  A part with no span is left out."""
    spans = {e["args"]["id"]: e for e in hub_events if e.get("ph") == "X"}

    def inside(ev, name):
        parent = ev["args"].get("parent")
        while parent is not None and parent in spans:
            if spans[parent]["name"] == name:
                return True
            parent = spans[parent]["args"].get("parent")
        return False

    loads = [e for e in spans.values() if e["name"] == "kernels.load"]
    setups = [e for e in spans.values() if e["name"] == "graph.setup"]
    out = {}
    if loads:
        out["kernels"] = sum(e["dur"] for e in loads) * 1e-6
    if setups:
        out["graph"] = (sum(e["dur"] for e in setups)
                        - sum(e["dur"] for e in loads
                              if inside(e, "graph.setup"))) * 1e-6
    return out
