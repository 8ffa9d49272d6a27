"""What the benchmark reads from ``torch.profiler``: the device's timeline
over a run of back-to-back proxy runs, and the product calls of eager
runs with their shapes.

The timeline comes from the profiler's exported trace, written to a
temporary file in ``TMPDIR`` and deleted once read.  Device operations
are its kernels, copies and fills; what the host was doing is its CUDA
runtime and driver calls and its operators.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from portbench import counts

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op")
#: the operators whose calls are matrix products, on either substrate
PRODUCT_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
               "repro_torch::matmul")
TOP = 10
LOOK_BACK = 64


@dataclass
class Timeline:
    """Device operations and host calls, (name, start_us, dur_us)."""

    device: List[Tuple[str, str, float, float]]
    host: List[Tuple[str, float, float]]


@dataclass
class Trace:
    """The traced part of a run, as the per-layer readers see it."""

    replays: int
    kernels: int
    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    #: (operator, input shapes, device microseconds) of each product call
    products: List[Tuple[str, List[List[int]], float]] = field(
        default_factory=list)
    eager_runs: int = 0
    inputgen_ms: float = None


def _profile(activities_cuda: bool, record_shapes: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if activities_cuda:
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, record_shapes=record_shapes)


def timeline(work: Callable[[], None], device: torch.device) -> Timeline:
    """Profile ``work`` (which ends in a synchronise) and read back its
    exported trace."""
    with _profile(True, False) as prof:
        work()
        torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    dev, host = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat"), str(ev.get("name"))
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((name, cat, ts, dur))
        elif cat in HOST_CATS:
            host.append((name, ts, dur))
    dev.sort(key=lambda e: e[2])
    host.sort(key=lambda e: e[1])
    return Timeline(dev, host)


def merged(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    """Sorted (start, end) intervals with overlaps joined."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def host_call_at(host: Sequence[Tuple[str, float, float]],
                 starts: Sequence[float], t: float) -> str:
    """The innermost host call running at ``t``: of the calls that cover
    it, the one that started last (``starts``: the calls' start times,
    sorted).  Looks back over at most ``LOOK_BACK`` calls."""
    i = bisect.bisect_right(starts, t)
    for name, ts, dur in reversed(host[max(i - LOOK_BACK, 0):i]):
        if ts + dur > t:
            return name
    return "no host call"


def _top(totals: Dict[str, float]) -> List[Tuple[str, float]]:
    return sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]


def reduce(tl: Timeline, replays: int) -> Trace:
    """Busy time, window, launches, the longest device operations and the
    idle gaps by what the host was doing, over ``replays`` runs."""
    if not tl.device:
        return Trace(replays, 0, 0.0, 0.0, [], [])
    spans = merged([(ts, ts + dur) for _, _, ts, dur in tl.device])
    busy_us = sum(e - s for s, e in spans)
    window_us = spans[-1][1] - spans[0][0]
    ops: Dict[str, float] = {}
    for name, _, _, dur in tl.device:
        ops[name] = ops.get(name, 0.0) + dur * 1e-6
    gaps: Dict[str, float] = {}
    starts = [ts for _, ts, _ in tl.host]
    for (_, end), (start, _) in zip(spans, spans[1:]):
        if start > end:
            label = host_call_at(tl.host, starts, end)
            gaps[label] = gaps.get(label, 0.0) + (start - end) * 1e-6
    kernels = sum(1 for _, cat, _, _ in tl.device if cat == "kernel")
    return Trace(replays, kernels, busy_us * 1e-6, window_us * 1e-6,
                 _top(ops), _top(gaps))


def _device_us(e) -> float:
    """Device microseconds of the kernels an operator and its callees
    launched."""
    return (sum(k.duration for k in e.kernels)
            + sum(_device_us(c) for c in e.cpu_children))


def _outermost(e) -> bool:
    p = e.cpu_parent
    while p is not None:
        if p.name in PRODUCT_OPS:
            return False
        p = p.cpu_parent
    return True


def product_calls(work: Callable[[], None], device: torch.device
                  ) -> List[Tuple[str, List[List[int]], float]]:
    """(operator, input shapes, device us) of every matrix product that
    ``work`` runs, each with the kernels it and its callees launched; a
    product inside another (the hand-written op's fallback on the CPU)
    is its caller's."""
    with _profile(device.type == "cuda", True) as prof:
        work()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return [(e.name, [list(s) for s in e.input_shapes], float(_device_us(e)))
            for e in prof.events()
            if e.name in PRODUCT_OPS and _outermost(e)]


def product_work(op: str, shapes: Sequence[Sequence[int]]) -> counts.Work:
    """The least work of one product call, from its operands' shapes."""
    mats = [s for s in shapes if len(s) >= 2]
    if op in ("aten::bmm", "aten::baddbmm"):
        (b, m, k), (_, _, n) = mats[-2], mats[-1]
        return counts.bmm(b, m, k, n)
    (m, k), (_, n) = mats[-2][-2:], mats[-1][-2:]
    return counts.matmul(m, k, n)
