"""Stress/conformance tier: deliberately hostile scenarios, graceful gates;
port of ``benchmarks/stress_matrix.py`` onto ``torch.distributed``.

The scenario matrix (``bench/scenario_matrix.py``) scores the paper's
*accuracy* claims at comfortable operating points.  This tier is the
other half: a registry of hostile cases — extreme ``data_scale``,
``zipf_alpha`` skew sweeps, degenerate 1xN / Nx1 meshes, indivisible
and oversubscribed scenarios, store corruption, mid-run fault injection
through ``runtime/fault_tolerance.py``, and the changing-cluster repro
(tune under a 2-D mesh, drop a device, re-qualify) — gated on
**graceful behaviour**, never on accuracy:

* ``no_uncaught``     — every case completes or fails via a typed error,
                        and every rank's case ends the same way;
* ``typed_errors``    — must-fail cases raise exactly their declared
                        error types (``ClusterError`` & co), not generic
                        crashes;
* ``bounded_retries`` — fault-injected runs recover within the runner's
                        ``max_retries_per_step`` budget;
* ``balanced_spans``  — the telemetry span stack is empty after every
                        case (no span leaks across failures);
* ``requalified``     — the device-drop case's quantized proxy is a
                        quantize fixed point with finite metrics under
                        the shrunken mesh, or the shrink failed with a
                        typed, actionable ``ClusterError``.

The canonical gate definitions live in the stress-tier contract table of
``docs/TUNER.md``.  Results append to ``results/stress_matrix.json`` (one
record per run, so the history accumulates).

SPMD: every rank runs every case in the same order, each in its own
scratch directory (stores and checkpoints never collide); a rank is one
device of the reference's host.  Rank 0 gathers every rank's records,
the gates hold over all of them, and rank 0 writes the document, whose
``cases`` are rank 0's records and ``ranks`` every rank's, with its
kernel launches and device-memory peak.  When this module is the entry
point and no process group exists, it starts ``REPRO_EMU_DEVICES`` ranks
(default 2, the reference's) on this host, gloo between them (on CUDA
too: the ranks may share one card).

Usage::

  REPRO_EMU_DEVICES=2 PYTHONPATH=src python -m \\
      repro_torch.bench.stress_matrix --quick --check --device cpu

Flags (the reference's, plus ``--device``, ``--substrate`` and
``--timeout``):
  --quick          smaller sizes (the extreme scale at 1<<18 keys)
  --check          exit nonzero when any graceful gate fails
  --cases C        comma-separated case filter (default: all registered;
                   --quick restricts to quick cases)
  --out PATH       the history file (default results/stress_matrix.json)
  --device D       cuda (the default) or cpu
  --substrate S    torch (stock ATen) or hopper: every case's sort node,
                   and the device-drop case's sort/quick hint, lower
                   onto the bitonic sort kernel
  --timeout S      seconds the started ranks may take together (1200)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import sys
import tempfile
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.bench._io import write_json
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import (
    ClusterError,
    ClusterScenario,
    EvalSession,
    MotifHint,
    ProxyStore,
    generate_proxy,
    get_scenario,
    mesh_structural_key,
    quantize_proxy,
    shrink_scenario,
    workload_signature,
)
from repro_torch.core.cluster import (
    EMU_DEVICES_ENV,
    agree,
    batch_quantum,
    in_mesh,
    model_quantum,
)
from repro_torch.core.motifs import PVector
from repro_torch.core.motifs.base import SUBSTRATES
from repro_torch.core.proxy_graph import GraphError, MotifNode, ProxyBenchmark
from repro_torch.device import resolve_device
from repro_torch.distributed.launch import gather_objects as _gather
from repro_torch.distributed.launch import rank as _rank
from repro_torch.distributed.pipeline_parallel import (
    gpipe_reference,
    pipeline_apply,
)
from repro_torch.distributed.sharding import clear_dropped, dropped_shardings
from repro_torch.runtime.fault_tolerance import (
    FaultTolerantRunner,
    RunnerConfig,
    StepMonitor,
)
from repro_torch.runtime.telemetry import Telemetry

#: the graceful-behaviour gates this tier enforces — canonical
#: definitions in the docs/TUNER.md stress-tier contract table
GRACEFUL_GATES: Tuple[str, ...] = (
    "no_uncaught",
    "typed_errors",
    "bounded_retries",
    "balanced_spans",
    "requalified",
)

#: stress-case families (the registry's ``kind`` vocabulary)
STRESS_KINDS: Tuple[str, ...] = (
    "scale", "skew", "mesh", "store", "fault", "drop")


@dataclasses.dataclass
class StressContext:
    """Per-run shared state every case receives."""

    quick: bool
    hub: Telemetry
    workdir: str  # scratch dir (stores, checkpoints); wiped per run
    device: Optional[str] = None  # cuda unless the caller asks for cpu
    substrate: str = "torch"

    @property
    def dev(self) -> torch.device:
        return resolve_device(self.device)


@dataclasses.dataclass(frozen=True)
class StressCase:
    name: str
    kind: str
    fn: Callable[[StressContext], Optional[Dict[str, Any]]]
    #: exception types that count as a TYPED failure (graceful); anything
    #: else is an uncaught crash and trips the no_uncaught gate
    expect: Tuple[type, ...] = (ClusterError,)
    #: a hostile definition that MUST fail typed — completing normally is
    #: itself a conformance violation (the typed_errors gate)
    must_fail: bool = False
    #: part of the --quick subset CI smoke runs
    quick: bool = True


STRESS_CASES: "OrderedDict[str, StressCase]" = OrderedDict()


def stress_case(name: str, kind: str, expect: Tuple[type, ...] = (ClusterError,),
                must_fail: bool = False, quick: bool = True):
    if kind not in STRESS_KINDS:
        raise ValueError(f"unknown stress kind {kind!r}")

    def deco(fn):
        STRESS_CASES[name] = StressCase(name, kind, fn, tuple(expect),
                                        must_fail, quick)
        return fn
    return deco


# ---------------------------------------------------------------------------
# Shared fixtures
# ---------------------------------------------------------------------------

_BASE_P = PVector(data_size=1 << 10, chunk_size=1 << 6, num_tasks=2,
                  batch_size=2, height=8, width=8, channels=4)


def _pb(ctx: StressContext, name: str = "stress",
        **p_updates) -> ProxyBenchmark:
    pb = ProxyBenchmark(name, (MotifNode("n0", "sort", "",
                                         _BASE_P.replace(**p_updates)),))
    pb.validate()
    return pb.with_substrate(ctx.substrate)


def _session(ctx: StressContext, **kw) -> EvalSession:
    return EvalSession(run=False, telemetry=ctx.hub, device=ctx.dev,
                       substrate=ctx.substrate, **kw)


def _finite(metrics: Dict[str, float]) -> bool:
    return all(math.isfinite(float(v)) for v in metrics.values())


def _devices() -> int:
    """The devices this host offers the tier: the process group's ranks
    (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _widest_2d_scenario() -> ClusterScenario:
    """The widest registered 2-D scenario the ranks can host — the
    tune-then-drop case's starting topology."""
    n = _devices()
    for name in ("dp4_mp2", "dp2_mp2", "dp2_mp1"):
        scn = get_scenario(name)
        if scn.device_count <= n:
            return scn
    raise ClusterError(
        f"stress tier needs >= 2 ranks for the device-drop case, have "
        f"{n}; start 2 or more ({EMU_DEVICES_ENV}=2)")


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------


@stress_case("extreme_data_scale", "scale", expect=(GraphError,))
def case_extreme_data_scale(ctx: StressContext) -> Dict[str, Any]:
    """Data volume far beyond the tuner's comfortable operating points:
    the evaluator must still profile and report finite metrics (run=False
    is one profiled dispatch run: the sort really runs, untimed)."""
    data_size = 1 << (18 if ctx.quick else 22)
    pb = _pb(ctx, "stress_scale", data_size=data_size, chunk_size=1 << 10)
    metrics = _session(ctx).evaluate(pb)
    assert _finite(metrics), f"non-finite metrics at {data_size}: {metrics}"
    return {"data_size": data_size, "metrics_finite": True}


@stress_case("zipf_skew_sweep", "skew", expect=(GraphError,))
def case_zipf_skew_sweep(ctx: StressContext) -> Dict[str, Any]:
    """Hostile key-skew sweep: ``zipf_alpha`` from uniform to extreme.

    Skew is a *lifted* (non-structural) data characteristic, so the whole
    sweep must hit ONE profiled shape class — and every point must report
    finite metrics."""
    alphas = (0.0, 1.2, 3.0, 8.0)
    session = _session(ctx)
    for a in alphas:
        metrics = session.evaluate(_pb(ctx, "stress_skew", zipf_alpha=a))
        assert _finite(metrics), f"non-finite metrics at alpha={a}"
    compiles = session.stats()["compiles"]
    assert compiles == 1, (
        f"skew sweep split into {compiles} shape classes; zipf_alpha "
        f"must stay lifted (non-structural)")
    return {"alphas": list(alphas), "compiles": compiles}


@stress_case("degenerate_meshes", "mesh")
def case_degenerate_meshes(ctx: StressContext) -> Dict[str, Any]:
    """1xN and Nx1 ``data x model`` meshes over every rank — all
    parallelism on one axis.

    Both must quantize (idempotently), evaluate with finite metrics, and
    key the executable cache differently (same device count, different
    partitioning).  Raises ClusterError (typed) with one rank."""
    n = _devices()
    if n < 2:
        raise ClusterError(
            f"degenerate-mesh case needs >= 2 ranks, have {n}")
    out: Dict[str, Any] = {}
    keys = []
    clear_dropped()
    for shape, tag in (((1, n), "1xN"), ((n, 1), "Nx1")):
        scn = ClusterScenario(f"stress_{tag}", n, shape, ("data", "model"))
        mesh = scn.mesh(ctx.dev.type)
        keys.append(mesh_structural_key(mesh))
        pbq = quantize_proxy(
            _pb(ctx, f"stress_{tag}", data_size=(1 << 10) + 3), mesh)
        assert quantize_proxy(pbq, mesh) is pbq, "quantize not idempotent"
        metrics = _session(ctx, mesh=mesh).evaluate(pbq)
        assert _finite(metrics), f"non-finite metrics on {tag}"
        out[tag] = {"mesh_shape": list(shape),
                    "batch_quantum": batch_quantum(mesh),
                    "model_quantum": model_quantum(mesh)}
    assert keys[0] != keys[1], "1xN and Nx1 meshes must key differently"
    # quantized proxies on degenerate meshes must never degrade to
    # silent replication: the happy path records zero dropped shardings
    assert dropped_shardings() == {}, dropped_shardings()
    return out


@stress_case("indivisible_mesh", "mesh", must_fail=True)
def case_indivisible_mesh(ctx: StressContext) -> None:
    """A mesh shape that does not factor its device count must be a
    loud, typed definition error — never a silent smaller cluster."""
    ClusterScenario("stress_indivisible", 6, (4, 2), ("data", "model"))


@stress_case("oversubscribed_mesh", "mesh", must_fail=True)
def case_oversubscribed_mesh(ctx: StressContext) -> None:
    """A scenario needing more ranks than the group has must raise the
    actionable ClusterError (naming ``REPRO_EMU_DEVICES``), not hang."""
    n = _devices()
    ClusterScenario("stress_oversub", n * 64, (n * 64,),
                    ("data",)).mesh(ctx.dev.type)


@stress_case("pipeline_degenerate", "mesh")
def case_pipeline_degenerate(ctx: StressContext) -> Dict[str, Any]:
    """GPipe over every rank as a stage — the deepest pipeline this host
    can express, fill/drain dominated — must still match the sequential
    oracle in float32."""
    n = _devices()
    mesh = ClusterScenario("stress_pipe", n, (n,), ("pipe",)).mesh(
        ctx.dev.type)  # None with one rank: one stage
    num_mb, mb, dim = n, 4, 8
    params = torch.linspace(0.5, 1.5, n, dtype=torch.float32,
                            device=ctx.dev).reshape(n, 1)
    x = torch.arange(num_mb * mb * dim, dtype=torch.float32,
                     device=ctx.dev).reshape(num_mb, mb, dim)

    def stage_fn(p, h):
        return torch.tanh(h * p)

    got = pipeline_apply(stage_fn, params, x, mesh, axis="pipe")
    want = gpipe_reference(stage_fn, params, x)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6), (
        "pipeline output diverged from the sequential oracle")
    return {"stages": n, "microbatches": num_mb, "allclose": True}


@stress_case("store_corruption", "store")
def case_store_corruption(ctx: StressContext) -> Dict[str, Any]:
    """Corrupt every persisted store entry, then warm-start a session:
    the cold-profile path must silently take over (store_invalid counts
    the skips), and the served metrics must match the uncorrupted run."""
    root = os.path.join(ctx.workdir, "store_corruption")
    pb = _pb(ctx, "stress_store")

    store1 = ProxyStore(root)
    want = _session(ctx, store=store1).evaluate(pb)
    assert store1.saves > 0, "nothing persisted; corruption case is vacuous"

    corrupted = 0
    for dirpath, _dirnames, filenames in os.walk(root):
        for f in filenames:
            if f.endswith(".json"):
                # reprolint: ignore[atomic-io] — a torn entry is the point
                with open(os.path.join(dirpath, f), "w") as fh:
                    fh.write("{corrupt!")  # syntactically invalid
                corrupted += 1
    assert corrupted > 0

    store2 = ProxyStore(root)
    # must NOT raise: corrupt entry -> miss -> profile
    got = _session(ctx, store=store2).evaluate(pb)
    assert got == want, "fallback profile served different metrics"
    assert store2.invalid > 0, (
        "corrupt entries were not detected (store_invalid == 0)")
    return {"corrupted_files": corrupted,
            "store_invalid": store2.invalid,
            "metrics_match": True}


@stress_case("fault_injection_restore", "fault", expect=(RuntimeError,))
def case_fault_injection_restore(ctx: StressContext) -> Dict[str, Any]:
    """A mid-run device-loss analog: the fault hook raises once, the
    runner restores from the last good checkpoint, recovers within its
    retry budget, and the EMA baseline stays clean of the failed wall."""
    ckpt_dir = os.path.join(ctx.workdir, "fault_restore")
    crashes = {"n": 0}
    dev = ctx.dev

    def hook(step):
        if step == 3 and crashes["n"] == 0:
            crashes["n"] += 1
            raise RuntimeError("injected device drop at step 3")

    def train_step(state, batch):
        new = {"w": state["w"] + batch,
               "step_count": state["step_count"] + 1}
        return new, {"loss": torch.sum(new["w"])}

    cfg = RunnerConfig(total_steps=6, checkpoint_every=2,
                       max_retries_per_step=2, async_save=False)
    runner = FaultTolerantRunner(
        train_step, {"w": torch.zeros(2, device=dev),
                     "step_count": torch.zeros((), device=dev)},
        CheckpointManager(ckpt_dir, keep=3), cfg,
        monitor=StepMonitor(), fault_hook=hook)
    out = runner.run(lambda step: torch.ones(2, device=dev))
    assert out["final_step"] == cfg.total_steps
    assert crashes["n"] == 1
    return {"recoveries": out["recoveries"],
            "max_retries": cfg.max_retries_per_step,
            "final_step": out["final_step"],
            "ema_s": runner.monitor.ema_s,
            "stragglers": out["stragglers"]}


@stress_case("fault_exhausts_retries", "fault", expect=(RuntimeError,),
             must_fail=True)
def case_fault_exhausts_retries(ctx: StressContext) -> None:
    """A persistent fault must exhaust the bounded retry budget and
    re-raise the ORIGINAL typed error — not loop forever, not swallow."""
    ckpt_dir = os.path.join(ctx.workdir, "fault_exhaust")
    dev = ctx.dev

    def hook(step):
        if step == 1:
            raise RuntimeError("persistent hard fault")

    def train_step(state, batch):
        return {"w": state["w"] + batch}, {"loss": torch.sum(state["w"])}

    cfg = RunnerConfig(total_steps=4, checkpoint_every=2,
                       max_retries_per_step=2, async_save=False)
    runner = FaultTolerantRunner(
        train_step, {"w": torch.zeros(2, device=dev)},
        CheckpointManager(ckpt_dir, keep=3), cfg,
        monitor=StepMonitor(), fault_hook=hook)
    runner.run(lambda step: torch.ones(2, device=dev))  # must raise


@stress_case("device_drop_requalify", "drop")
def case_device_drop_requalify(ctx: StressContext) -> Dict[str, Any]:
    """The changing-cluster repro (paper §III-D, stretch): tune under the
    widest 2-D mesh the ranks offer, drop one device, and either the
    quantized proxy re-qualifies under the shrunken mesh (quantize fixed
    point + finite metrics) or the shrink fails with a typed, actionable
    ClusterError naming the incompatible axis.  The shrunken mesh's
    ranks replay; every rank reports their verdict."""
    scn = _widest_2d_scenario()
    mesh = scn.mesh(ctx.dev.type)

    def wl(x):
        return torch.sum(torch.sort(x).values * x)

    x = torch.linspace(0.0, 1.0, 4096, dtype=torch.float32, device=ctx.dev)
    tsig = workload_signature(wl, (x,), ("batch",), mesh, run=False)
    session = _session(ctx, mesh=mesh)
    pb_t, rep = generate_proxy(
        wl, x, name="stress_drop", hints=[MotifHint("sort", "quick")],
        base_p=PVector(data_size=(1 << 10) + 3, chunk_size=1 << 6,
                       num_tasks=2),
        max_iters=1, run=False, target_signature=tsig, session=session,
        device=ctx.dev)
    assert rep.qualification_rate == 1.0, rep.qualification_rate

    out: Dict[str, Any] = {"tuned_under": scn.name,
                           "mesh_shape": list(scn.mesh_shape),
                           "qualification_rate": rep.qualification_rate}
    drop = 1
    try:
        shrunk = shrink_scenario(scn, drop)
    except ClusterError as e:
        # dropping 1 from e.g. (2, 2) cannot preserve the model axis —
        # that IS the typed, actionable path; the next feasible shrink
        # (a full model-group) must then work
        out["drop1_typed_error"] = str(e)
        drop = scn.mesh_shape[1] if len(scn.mesh_shape) > 1 else 1
        shrunk = shrink_scenario(scn, drop)
    new_mesh = shrunk.mesh(ctx.dev.type)  # None when one device remains
    out["replay_under"] = {"name": shrunk.name,
                           "devices": shrunk.device_count,
                           "mesh_shape": list(shrunk.mesh_shape)}

    verdict = None
    if in_mesh(new_mesh):
        pbq = quantize_proxy(pb_t, new_mesh)
        fixed = quantize_proxy(pbq, new_mesh) is pbq
        metrics = _session(ctx, mesh=new_mesh).evaluate(pbq)
        verdict = (fixed, metrics)
    # the shrunken mesh's first rank is the old mesh's: its verdict
    fixed, metrics = agree(verdict, mesh)
    out["requalified"] = bool(fixed and _finite(metrics))
    assert out["requalified"], (
        f"proxy failed to re-qualify under {shrunk.name}: "
        f"fixed_point={fixed}, metrics={metrics}")
    return out


# ---------------------------------------------------------------------------
# Running the tier
# ---------------------------------------------------------------------------


def run_case(case: StressCase, ctx: StressContext) -> Dict[str, Any]:
    """One case, classified: completed / typed_failure / uncaught.

    The tier itself may never crash — that is its contract —
    and the span stack must be empty afterwards whatever happened (the
    balanced_spans gate)."""
    rec: Dict[str, Any] = {"case": case.name, "kind": case.kind,
                           "must_fail": case.must_fail}
    try:
        # 'stress.case' is the reference benchmark's own span
        # (benchmarks/stress_matrix.py); docs/OBSERVABILITY.md omits it
        # reprolint: ignore[telemetry-names]
        with ctx.hub.span("stress.case", case=case.name):
            payload = case.fn(ctx)
        rec["status"] = "completed"
        if payload:
            rec.update(payload)
    except case.expect as e:
        rec["status"] = "typed_failure"
        rec["error_type"] = type(e).__name__
        rec["error"] = str(e)[:300]
    except Exception as e:  # noqa: BLE001 — classified, reported, gated
        rec["status"] = "uncaught"
        rec["error_type"] = type(e).__name__
        rec["error"] = str(e)[:500]
    rec["balanced_spans"] = not ctx.hub._stack()
    return rec


def evaluate_gates(results: List[Dict[str, Any]]
                   ) -> Tuple[Dict[str, bool], List[str]]:
    """The graceful-behaviour verdict over one run's case records (every
    rank's: records carrying a ``rank`` must end alike across ranks, or
    ``no_uncaught`` fails)."""
    failures: List[str] = []
    gates = {g: True for g in GRACEFUL_GATES}
    statuses: Dict[str, set] = {}
    for rec in results:
        name = rec["case"]
        if "rank" in rec:
            statuses.setdefault(name, set()).add(rec["status"])
        if rec["status"] == "uncaught":
            gates["no_uncaught"] = False
            failures.append(f"{name}: uncaught {rec['error_type']}: "
                            f"{rec.get('error', '')}")
        if rec["must_fail"] and rec["status"] != "typed_failure":
            gates["typed_errors"] = False
            failures.append(f"{name}: hostile definition must fail typed, "
                            f"got status={rec['status']}")
        if not rec.get("balanced_spans", True):
            gates["balanced_spans"] = False
            failures.append(f"{name}: telemetry span stack not empty "
                            f"after the case")
        if ("recoveries" in rec and "max_retries" in rec
                and rec["recoveries"] > rec["max_retries"]):
            gates["bounded_retries"] = False
            failures.append(f"{name}: {rec['recoveries']} recoveries "
                            f"exceed the {rec['max_retries']}-retry budget")
        if rec["kind"] == "drop" and rec["status"] == "completed" \
                and not rec.get("requalified"):
            gates["requalified"] = False
            failures.append(f"{name}: device-drop proxy did not re-qualify "
                            f"and did not fail typed")
    for name, seen in statuses.items():
        if len(seen) > 1:
            gates["no_uncaught"] = False
            failures.append(f"{name}: ranks ended differently: "
                            f"{sorted(seen)}")
    # (the requalified gate is vacuously True when no drop case ran)
    return gates, failures


def _peak(device: torch.device) -> Tuple[int, int]:
    """The allocator's (allocated, reserved) peaks since they were last
    reset; every profile resets them for its own measure, so the caller
    reads them after each case."""
    if device.type != "cuda":
        return 0, 0
    return (torch.cuda.max_memory_allocated(device),
            torch.cuda.max_memory_reserved(device))


def _rank_record(hub: Telemetry, peaks) -> Dict[str, Any]:
    """This rank's kernel launches, device-memory peaks (the largest read
    after a case) and dropped spans."""
    from repro_torch.kernels.ops import launch_counts

    return {"rank": _rank(), "launches": launch_counts(),
            "max_allocated_bytes": max(a for a, _ in peaks),
            "max_reserved_bytes": max(r for _, r in peaks),
            "spans_dropped": hub.snapshot().get("spans_dropped", 0)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="the CI smoke subset (smaller sizes)")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero when any graceful gate fails")
    ap.add_argument("--cases", default=None,
                    help="comma-separated case filter (default: all "
                         "registered; --quick restricts to quick cases)")
    ap.add_argument("--out", default="results/stress_matrix.json")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--substrate", default="torch", choices=SUBSTRATES,
                    help="hopper: the cases' sorts on the bitonic kernel")
    ap.add_argument("--timeout", type=float, default=1200.0,
                    help="seconds the ranks this entry point starts may "
                         "take together")
    return ap.parse_args(argv)


def run(args) -> int:
    """The tier on this rank of an initialised process group (or alone
    without one)."""
    names = (args.cases.split(",") if args.cases else list(STRESS_CASES))
    unknown = [n for n in names if n not in STRESS_CASES]
    if unknown:
        print(f"[stress_matrix] unknown cases {unknown}; have "
              f"{sorted(STRESS_CASES)}", file=sys.stderr)
        return 2
    cases = [STRESS_CASES[n] for n in names
             if not args.quick or STRESS_CASES[n].quick]

    dev = resolve_device(args.device)
    hub = Telemetry()
    workdir = tempfile.mkdtemp(prefix=f"stress_matrix_r{_rank()}_")
    ctx = StressContext(quick=args.quick, hub=hub, workdir=workdir,
                        device=str(dev), substrate=args.substrate)
    lead = _rank() == 0
    if lead:
        print(f"[stress_matrix] {_devices()} ranks on {dev}, substrate "
              f"{args.substrate}; {len(cases)} cases: "
              f"{[c.name for c in cases]}", flush=True)

    results, peaks = [], [(0, 0)]
    try:
        for case in cases:
            rec = run_case(case, ctx)
            results.append(rec)
            peaks.append(_peak(dev))
            if lead:
                print(f"  {case.name:26s} [{case.kind:5s}] {rec['status']}"
                      + (f" ({rec.get('error_type')})"
                         if rec["status"] != "completed" else ""),
                      flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    everyone = _gather({"results": results, **_rank_record(hub, peaks)})
    if not lead:
        return 0
    gates, failures = evaluate_gates(
        [{**rec, "rank": r["rank"]} for r in everyone
         for rec in r["results"]])
    run_rec = {
        "devices": _devices(),
        "quick": bool(args.quick),
        "cases": results,
        "gates": gates,
        "failures": failures,
        "spans_dropped": sum(r["spans_dropped"] for r in everyone),
        "device": str(dev),
        "substrate": args.substrate,
        "ranks": everyone,
    }

    # append, never overwrite: the stress history accumulates across
    # runs (an unreadable existing artifact starts a fresh history)
    doc = {"runs": []}
    try:
        with open(args.out) as fh:
            prev = json.load(fh)
        if isinstance(prev, dict) and isinstance(prev.get("runs"), list):
            doc = prev
    except (OSError, ValueError):
        pass
    doc["runs"].append(run_rec)
    write_json(args.out, doc)
    print(f"[stress_matrix] wrote {args.out} "
          f"(run {len(doc['runs'])} of the history)")

    print("\n=== stress tier (graceful-behaviour gates) ===")
    for g in GRACEFUL_GATES:
        print(f"  {g:16s} {'PASS' if gates[g] else 'FAIL'}")
    if failures:
        print("\n[stress_matrix] FAILURES:", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
    if args.check and failures:
        return 1
    return 0


def _rank_main(argv) -> int:
    return run(parse_args(argv))


def main(argv=None) -> int:
    """Run the tier.  Inside a process group every rank calls this;
    without one it starts ``REPRO_EMU_DEVICES`` ranks (default 2) and
    returns rank 0's exit code."""
    args = parse_args(argv)
    if dist.is_available() and dist.is_initialized():
        return run(args)
    from repro_torch.distributed.launch import spawn

    n = int(os.environ.get(EMU_DEVICES_ENV, "2"))
    dev = resolve_device(args.device)  # raises without a card
    if dev.type == "cuda":  # build the kernels once, not once a rank
        from repro_torch.kernels import _build

        _build.library()
    codes = spawn(_rank_main, n, list(argv if argv is not None
                                      else sys.argv[1:]),
                  device_type=dev.type, timeout_s=args.timeout)
    return int(codes[0])


if __name__ == "__main__":
    raise SystemExit(main())
