"""One run of one cell: a frozen proxy run back to back on the port,
timed, optionally traced, and held against the plain reference.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Everything it
needs is found by name: its configuration's file (the frozen proxy), its
traffic mix ``traffic/<traffic>.json``, its limits ``limits/<cell>.json``
and one reader ``metrics/<metric>.py`` for each metric it reports.  A
later cell, mix or metric is added by adding files.

The timed path is the port's: ``ProxyBenchmark.from_json``,
``with_substrate`` (the mix's), ``build_fn`` for the seed, captured once
as a CUDA graph (``CapturedGraph``, which reseeds the proxy's generators
before each replay) and replayed back to back, a CUDA event recorded
after each replay.  Where the capture fails the run goes eager and says
so.  The last replay's outputs of every node are compared with the
reference's (``check.py``).
"""
from __future__ import annotations

import importlib.util
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from portbench import check, counts, devtrace, reference

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names the harness's process may not hold: the JAX
#: stack and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the traced part of a run: at least this many replays, and enough for
#: this many seconds of device time, up to the most
TRACE_REPLAYS = (20, 0.25, 100)
#: eager runs profiled for the product calls
EAGER_RUNS = 3
#: runs the closed loop keeps queued on the card
INFLIGHT = 4
#: device seconds the input generation is timed over, at least
INPUTGEN_S = 0.25


class ProgramMissing(RuntimeError):
    """The checkout holds no program to measure."""


@dataclass(frozen=True)
class Cell:
    name: str
    config: Mapping[str, Any]
    traffic: Mapping[str, Any]
    chips: int
    limits: Mapping[str, float]
    end_to_end: Tuple[Mapping[str, Any], ...]
    per_layer: Tuple[Mapping[str, Any], ...]
    root: Path


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """Cell ``name`` of ``root/BENCHMARK.json``, with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / "portbench"
    e2e = tuple(m for m in bench["end_to_end"]
                if name in m.get("workloads", [name]))
    reported = {m["name"] for m in e2e}
    per_layer = tuple(m for m in bench["per_layer"]
                      if (name in m["workloads"] if "workloads" in m
                          else m["moves"] in reported))
    return Cell(
        name=name,
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads((here / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        chips=int(w["chips"]),
        limits=json.loads((here / "limits" / f"{name}.json").read_text()),
        end_to_end=e2e, per_layer=per_layer, root=root)


def import_program(root: Path = ROOT):
    """The port, ``root/src/repro_torch``, and never another copy."""
    src = (root / "src").resolve()
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise ProgramMissing(f"no program at {src / 'repro_torch'}")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import repro_torch

    where = Path(repro_torch.__file__).resolve().parent
    if where != src / "repro_torch":
        raise ProgramMissing(f"repro_torch was imported from {where}, not "
                             f"from {src / 'repro_torch'}")
    return repro_torch


def forbidden_modules() -> List[str]:
    """Modules of this process whose top-level name is forbidden, the part
    before the first dot compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def load_reader(name: str, root: Path = ROOT) -> Callable:
    """``read(run) -> Optional[float]`` of metric ``name``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    if spec is None or not path.is_file():
        raise KeyError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class RunData:
    """What one run measured, as the metric readers see it."""

    setup_s: float
    window_s: float
    run_ms: List[float]
    flops_per_run: float
    peaks: Mapping[str, float]
    trace: Optional[devtrace.Trace] = None

    @property
    def runs(self) -> int:
        return len(self.run_ms)

    @property
    def proxy_ms(self) -> float:
        return self.window_s * 1e3 / self.runs


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Runner:
    """One run of the proxy from one seed: a replay of its CUDA graph, or
    an eager call where it cannot be captured (and on the CPU)."""

    def __init__(self, fn: Callable[[int], Any], seed: int,
                 device: torch.device):
        from repro_torch.core.signature import CapturedGraph, NotCaptured

        self.fn, self.seed, self.graph, self.last = fn, seed, None, None
        if device.type != "cuda":
            self.why_eager = "the cpu has no CUDA graphs"
        else:
            try:
                self.graph = CapturedGraph(lambda: fn(seed), device=device)
                self.why_eager = None
            except NotCaptured as exc:
                self.why_eager = f"not captured: {exc}"
        if self.graph is None:
            for _ in range(2):  # what the capture's warm-up would do
                self()

    @property
    def mode(self) -> str:
        return "graph" if self.graph is not None else "eager"

    def __call__(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        else:
            self.last = self.fn(self.seed)

    def outputs(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return self.graph.outputs if self.graph is not None else self.last

    def close(self) -> None:
        if self.graph is not None:
            self.graph.close()
        self.graph = self.last = None


def measure(run: Callable[[], None], seconds: float, device: torch.device,
            inflight: int) -> Tuple[float, List[float]]:
    """Run back to back for ``seconds``: (the window's seconds, each run's
    ms).  On the card the host keeps at most ``inflight`` runs queued,
    each run's time is the device's, between the CUDA events around it,
    and the window ends once the last run has finished."""
    if device.type != "cuda":
        times = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or not times:
            t = time.perf_counter()
            run()
            times.append((time.perf_counter() - t) * 1e3)
        return time.perf_counter() - t0, times
    marks = [torch.cuda.Event(enable_timing=True)]
    torch.cuda.synchronize(device)
    marks[0].record()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or len(marks) == 1:
        if len(marks) > inflight:
            marks[len(marks) - inflight].synchronize()
        run()
        mark = torch.cuda.Event(enable_timing=True)
        mark.record()
        marks.append(mark)
    torch.cuda.synchronize(device)
    window = time.perf_counter() - t0
    return window, [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def log_runs(run_ms: List[float]) -> None:
    """The window's runs: their spread, and their mean second by second
    (device time), on stderr."""
    q = statistics.quantiles(run_ms, n=20) if len(run_ms) > 1 else run_ms
    log(f"portbench: {len(run_ms)} runs, ms at 5/25/50/75/95 %: "
        + " ".join(f"{q[i]:.4f}" for i in (0, 4, 9, 14, 18)
                   if i < len(q)))
    means, acc, n = [], 0.0, 0
    for ms in run_ms:
        acc, n = acc + ms, n + 1
        if acc >= 1000.0:
            means.append(acc / n)
            acc, n = 0.0, 0
    log("portbench: mean ms a second: "
        + " ".join(f"{m:.4f}" for m in means))


def _replays(proxy_ms: float) -> int:
    least, seconds, most = TRACE_REPLAYS
    return int(min(most, max(least, math.ceil(seconds * 1e3 / proxy_ms))))


def inputgen_ms(pb, seed: int, device: torch.device) -> float:
    """Device ms of every node's input generation alone, with the run's
    seeds, captured and replayed as the proxy is."""
    from repro_torch.core.motifs.base import get_motif
    from repro_torch.core.signature import CapturedGraph
    from repro_torch.data.generators import derive_seed

    def make():
        return [get_motif(n.motif).make_inputs(n.p, derive_seed(seed, i),
                                               device)
                for i, n in enumerate(pb.nodes)]

    with CapturedGraph(make, device=device) as graph:
        graph.replay()
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        reps = max(1, math.ceil(INPUTGEN_S * 1e3 / start.elapsed_time(end)))
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps


class ProductsMissed(RuntimeError):
    """The profiled runs made another number of matrix products than the
    proxy holds: an operator that ``devtrace.PRODUCT_OPS`` does not list
    runs one."""


def product_calls(work: Callable[[], None], proxy, runs: int,
                  device: torch.device):
    """``devtrace.product_calls`` of ``runs`` eager runs, which have to
    hold every matrix product the proxy makes."""
    calls = devtrace.product_calls(work, device)
    want = runs * reference.products(proxy)
    if len(calls) != want:
        raise ProductsMissed(
            f"{len(calls)} product calls in {runs} eager runs, the proxy "
            f"makes {want}: list the operator that runs the others in "
            f"devtrace.PRODUCT_OPS")
    return calls


def trace_run(runner: Runner, fn: Callable[[int], Any], pb, proxy,
              seed: int, device: torch.device,
              proxy_ms: float) -> devtrace.Trace:
    """The traced part of a run, after the window: back-to-back runs
    under the profiler, eager runs with their product calls' shapes, and
    the input generation timed alone."""
    replays = _replays(proxy_ms)

    def work():
        for _ in range(replays):
            runner()

    tr = devtrace.reduce(devtrace.timeline(work, device), replays)

    def eager():
        for _ in range(EAGER_RUNS):
            fn(seed)

    tr.products = product_calls(eager, proxy, EAGER_RUNS, device)
    tr.eager_runs = EAGER_RUNS
    tr.inputgen_ms = inputgen_ms(pb, seed, device)
    return tr


def to_host(tree: Mapping[str, Mapping[str, torch.Tensor]]):
    return {node: {k: v.detach().to("cpu", copy=True)
                   for k, v in leaves.items()}
            for node, leaves in tree.items()}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float) -> Dict[str, Any]:
    """Set up, measure for ``seconds``, trace if asked, check; the result
    as the benchmark prints it."""
    import_program(cell.root)
    from repro_torch.core.proxy_graph import ProxyBenchmark

    seed = int(seed) % (1 << 63)
    proxy = cell.config["proxy"]
    pb = ProxyBenchmark.from_json(json.dumps(proxy)).with_substrate(
        cell.traffic["substrate"])
    fn = pb.build_fn(device)
    runner = Runner(fn, seed, device)
    mode = runner.mode
    if runner.why_eager:
        log(f"portbench: {cell.name} runs eager: {runner.why_eager}")
    runner()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    window_s, run_ms = measure(runner, seconds, device, INFLIGHT)
    log_runs(run_ms)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    data = RunData(setup_s, window_s, run_ms, reference.flops(proxy),
                   counts.PEAKS)
    if trace:
        data.trace = trace_run(runner, fn, pb, proxy, seed, device,
                               data.proxy_ms)

    got = to_host(runner.outputs())
    runner.close()
    del runner, fn, pb
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref, choices = reference.run(proxy, seed, device, "float64")
    ref = to_host(ref)
    choices = {n: {k: (s.to("cpu"), sense) for k, (s, sense) in c.items()}
               for n, c in choices.items()}
    numbers = check.compare(got, ref, choices)
    correct = check.judge(numbers, cell.limits)
    log(f"portbench: reference and comparison took "
        f"{time.perf_counter() - t_ref:.3f} s")

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = load_reader(m["name"], cell.root)(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result: Dict[str, Any] = {
        "correct": bool(correct), "attempted": data.runs,
        "failed": 0 if correct else data.runs, "metrics": metrics,
        "device": dev, "mode": mode, "seed": seed}
    if trace:
        tr = data.trace
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                               "idle_gaps": [list(x) for x in tr.idle_gaps]}
    result["checks"] = {k: {"value": v, "limit": cell.limits[k]}
                        for k, v in numbers.items()}
    return result
