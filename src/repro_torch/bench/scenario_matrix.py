"""Cluster-scenario matrix: the paper's "changing cluster configurations"
evaluation (§III-D) + cross-scenario trend consistency (§III-E); port of
``benchmarks/scenario_matrix.py`` onto ``torch.distributed``.

For each workload the script tunes ONE proxy at the base (single-device)
scenario, then re-measures that same proxy and the real workload under
every cluster scenario — a :class:`repro_torch.core.cluster.
ClusterScenario` mesh over the ranks of the process group — and reports
per-scenario Eq.-3 accuracy plus how consistently the proxy's metrics
*move* with the real workload's as the cluster changes (sign/rank
agreement of the per-metric deltas).  A final section benchmarks
population-parallel tuning: the same candidate batch through
``population_runtime`` on one rank vs split across the largest
scenario's ranks.

``--tune-under-mesh`` additionally RE-TUNES a proxy per multi-device
scenario under its mesh: the real workload's sharded profile is the
target (its collective bytes seed the decomposition), the mesh's
quantize rule rounds every candidate (``qualification_rate`` 1.0) and
the adjusting stage is prior-seeded.  The mesh-blind proxy stays the
incumbent: the re-tuned proxy replaces it only when its Eq.-3 accuracy
under the scenario is at least as good.  With >= 2 multi-device
scenarios it also scores trend consistency over the proxies the
incumbent rule selected (``trend_mesh_tuned``).

SPMD: every rank runs this script.  Rank 0 tunes the base proxy and
broadcasts it; the ranks of each scenario's mesh (the first
``device_count`` ranks) measure its cells together, the others skip
them; rank 0, in every mesh, writes the document.  A sharded profile is
the mesh's first rank's on every rank, a sharded wall the slowest
rank's, so the ranks' tuners move in step.  When this module is the
entry point and no process group exists, it starts ``REPRO_EMU_DEVICES``
ranks (default 4, the reference's variable) on this host, gloo between
them (on CUDA too: the ranks may share one card).  Scenarios needing
more ranks are skipped and listed in the output.

Usage::

  PYTHONPATH=src python -m repro_torch.bench.scenario_matrix [flags]

Flags (the reference's, plus ``--device``, ``--substrate`` and
``--timeout``):
  --quick          2 workloads, 2 tuning iterations, small scale
  --workloads W    comma list or "all" (default: quick pair / all)
  --scenarios S    comma list of registry names (default
                   single,dp2,dp4,dp2_mp2)
  --scale F        base input-scale multiplier (default 0.2)
  --iters N        max tuning iterations per workload (default 8)
  --no-run         profile-derived metrics only (no timing, no rates)
  --pop N          population-bench candidate count (default 32; 0 = off)
  --tune-under-mesh  re-tune a proxy per multi-device scenario (above)
  --check          exit nonzero unless: every multi-device scenario shows
                   nonzero collective bytes, the 1-device scenario's
                   proxy metric vector is bit-identical to the serial
                   path, (with --pop and a multi-device scenario) the
                   sharded population bench beats 1-device, (with
                   --tune-under-mesh) every re-tune reports
                   qualification_rate == 1.0 and a selected accuracy no
                   worse than the mesh-blind cell, plus — with >= 2
                   multi-device scenarios — a well-formed
                   trend_mesh_tuned block per workload; and (with
                   --substrate hopper) every proxy's outputs on dp2 equal
                   the stock ATen form's on the same mesh
  --out PATH       JSON output (default results/scenario_matrix.json)
  --store DIR      persistent ProxyStore shared by every scenario session
  --trace PATH     run with a live telemetry hub (rank 0) and export it
                   as Chrome trace-event JSON
  --device D       cuda (the default) or cpu
  --substrate S    torch (stock ATen) or hopper (the kernels)
  --timeout S      seconds the started ranks may take together (3000)

Output JSON: the reference's document, key for key::

  {"devices": int, "scenarios": [{name, device_count, mesh_shape,
   axis_names, data_scale, skipped?}, ...],
   "workloads": [{"workload", "proxy_json", "per_scenario": [
       {"scenario", "mean_accuracy", "per_metric_accuracy",
        "real_metrics", "proxy_metrics", "real_collective_bytes",
        "proxy_collective_bytes", "real_wall_s", "proxy_wall_s",
        "mesh_tuned"?: {...}}, ...],
     "trend": {...}, "trend_mesh_tuned": {...} | null}, ...],
   "population_bench": {candidates, classes, single_wall_s,
                        sharded_wall_s, sharded_devices, speedup},
   "parity": {workload: {"bit_identical": bool}},
   "session": {scenario: {"stats", "per_workload"}}}

plus the port's own keys: each cell's ``real_collectives`` and
``proxy_collectives`` (bytes by kind), ``real_timing`` / ``proxy_timing``
and ``real_sharded`` (whether any of the step's inputs splits on the
scenario's mesh); ``ranks`` (per rank: kernel launches, the device
memory's peak); ``substrate_parity`` with ``--substrate hopper``;
``check_failures`` (the gates that failed, as ``--check`` prints them).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any, Dict, List

import torch
import torch.distributed as dist

from repro_torch.bench._io import write_json
from repro_torch.bench.paper_repro import BASE_P
from repro_torch.core.accuracy import compare, normalized_vector
from repro_torch.core.cluster import (
    EMU_DEVICES_ENV,
    ClusterError,
    get_scenario,
    in_mesh,
    mesh_group,
    quantize_proxy,
    splits_inputs,
    trend_consistency,
    workload_signature,
)
from repro_torch.core.evaluator import EvalSession, serial_evaluate_batch
from repro_torch.core.generator import generate_proxy, select_metrics
from repro_torch.core.motifs.base import SUBSTRATES
from repro_torch.core.proxy_graph import ProxyBenchmark
from repro_torch.core.store import ProxyStore
from repro_torch.device import resolve_device
from repro_torch.distributed.launch import gather_objects as _gather
from repro_torch.distributed.launch import rank as _rank
from repro_torch.distributed.sharding import use_mesh, whole
from repro_torch.workloads import WORKLOADS

QUICK_WORKLOADS = ("terasort", "kmeans")
# dp2_mp2 puts one genuine 2-D (data x model) mesh in the default grid
DEFAULT_SCENARIOS = ("single", "dp2", "dp4", "dp2_mp2")


def say(*a, **kw) -> None:
    """Print on rank 0 only."""
    if _rank() == 0:
        print(*a, **kw, flush=True)


def resolve_scenarios(names, device=None):
    """Registry lookups + availability filter; returns (usable, records).
    Every rank calls this in the same order (building a mesh is
    collective)."""
    dtype = resolve_device(device).type
    usable, records = [], []
    for name in names:
        scn = get_scenario(name)
        rec = {"name": scn.name, "device_count": scn.device_count,
               "mesh_shape": list(scn.mesh_shape),
               "axis_names": list(scn.axis_names),
               "data_scale": scn.data_scale}
        try:
            scn.mesh(dtype)
        except ClusterError as e:
            rec["skipped"] = str(e)
            say(f"[scenario_matrix] skipping {name}: {e}")
        else:
            usable.append(scn)
        records.append(rec)
    return usable, records


def measure_scenario(w, pb, scn, session, scale, run, seed=0):
    """(real, proxy) metric vectors + signatures for one scenario cell,
    on the ranks of the scenario's mesh, and whether any of the step's
    inputs split on the mesh.

    ``session`` is the scenario's shared :class:`EvalSession` (one per
    scenario for the whole sweep)."""
    mesh = session.mesh
    args = w.inputs(seed, scale * scn.data_scale, device=session.device)
    real_sig = workload_signature(w.step, args, w.input_axes, mesh, run=run)
    # rounds data-volume fields up to the mesh quantum so no node's
    # sharding silently degrades to replication (identity on 1 device)
    with session.workload(w.name):
        proxy_sig = session.signature_of(quantize_proxy(pb, mesh))
    return (normalized_vector(real_sig, include_rates=run), real_sig,
            normalized_vector(proxy_sig, include_rates=run), proxy_sig,
            splits_inputs(args, w.input_axes, mesh))


def tune_under_mesh_cell(w, scn, session, real_sig, blind_acc,
                         iters, run, seed=0):
    """Re-tune one (workload, multi-device scenario) cell under its mesh,
    on every rank of the mesh in step.  ``real_sig`` (the cell's sharded
    real-workload profile) is the target; the mesh-blind proxy is the
    incumbent (the re-tuned one is selected only when its Eq.-3 accuracy
    is at least the blind cell's).  The block's ``proxy_metrics`` is the
    re-tuned proxy's full vector under the scenario."""
    pb_t, rep = generate_proxy(
        w.step, name=f"{w.name}@{scn.name}", hints=w.hints,
        base_p=BASE_P.get(w.name), max_iters=iters, run=run, seed=seed,
        target_signature=real_sig, session=session, priors=True,
        device=session.device)
    tuned_acc = rep.mean_accuracy
    selected = "mesh-tuned" if tuned_acc >= blind_acc else "mesh-blind"
    with session.workload(f"{w.name}@{scn.name}"):
        tuned_m = normalized_vector(session.signature_of(pb_t),
                                    include_rates=run)
    say(f"  {scn.name:12s} mesh-tuned acc={tuned_acc:6.1%} "
        f"(blind {blind_acc:6.1%}, {tuned_acc - blind_acc:+.1%}) "
        f"qual={rep.qualification_rate:.2f} -> {selected}")
    return {
        "mean_accuracy": tuned_acc,
        "accuracy_delta": tuned_acc - blind_acc,
        "qualification_rate": rep.qualification_rate,
        "prior_seeded": rep.prior_seeded,
        "selected": selected,
        "selected_accuracy": max(tuned_acc, blind_acc),
        "iterations": rep.iterations,
        "evals": rep.evals,
        "collective_shares": dict(pb_t.meta.get("collective_shares", {})),
        "proxy_metrics": tuned_m,
        "proxy_json": pb_t.to_json(),
    }


def _broadcast(obj):
    """Rank 0's ``obj`` on every rank of the process group."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def run_workload(name, scenarios, sessions, scale, iters, run, seed=0,
                 tuning_session=None, tune_under_mesh=False):
    """Tune one workload's proxy at the base scenario (rank 0) and
    measure it under every scenario (each mesh's ranks).  Every rank
    returns the proxy; rank 0 the record too."""
    w = WORKLOADS[name]
    pb_json = None
    if _rank() == 0:
        args = w.inputs(seed, scale, device=tuning_session.device)
        t0 = time.time()
        pb, rep = generate_proxy(
            w.step, *args, name=name, hints=w.hints,
            base_p=BASE_P.get(name), max_iters=iters, run=run, seed=seed,
            session=tuning_session, device=tuning_session.device)
        say(f"[scenario_matrix] {name}: tuned in {time.time() - t0:.0f}s "
            f"({rep.summary()})")
        pb_json = pb.to_json()
    # what one rank tuned, every rank measures
    pb = ProxyBenchmark.from_json(_broadcast(pb_json))

    cells, real_table, proxy_table = [], {}, {}
    selected_table = {}  # multi-device scenario -> SELECTED proxy's vector
    for scn in scenarios:
        session = sessions.get(scn.name)
        if session is None:
            continue  # this rank is outside the scenario's mesh
        t0 = time.time()
        real_m, real_sig, proxy_m, proxy_sig, sharded = measure_scenario(
            w, pb, scn, session, scale, run, seed)
        metrics = select_metrics(real_m, include_rates=run)
        acc = compare({k: real_m.get(k, 0.0) for k in metrics},
                      proxy_m, metrics)
        real_table[scn.name] = real_m
        proxy_table[scn.name] = proxy_m
        cells.append({
            "scenario": scn.name,
            "mean_accuracy": acc.mean,
            "per_metric_accuracy": dict(acc.per_metric),
            "real_metrics": real_m,
            "proxy_metrics": proxy_m,
            "real_collective_bytes": real_sig.total_collective_bytes,
            "proxy_collective_bytes": proxy_sig.total_collective_bytes,
            "real_wall_s": real_sig.wall_time,
            "proxy_wall_s": proxy_sig.wall_time,
            "real_sharded": sharded,
            "real_collectives": dict(real_sig.collective_bytes),
            "proxy_collectives": dict(proxy_sig.collective_bytes),
            "real_timing": dict(real_sig.timing),
            "proxy_timing": dict(proxy_sig.timing),
        })
        say(f"  {scn.name:12s} acc={acc.mean:6.1%} "
            f"real_coll={real_sig.total_collective_bytes:10.3g} "
            f"proxy_coll={proxy_sig.total_collective_bytes:10.3g} "
            f"({time.time() - t0:.1f}s)")
        if tune_under_mesh and scn.device_count > 1:
            t0 = time.time()
            mt = tune_under_mesh_cell(
                w, scn, session, real_sig, acc.mean, iters, run, seed)
            say(f"  {scn.name:12s} re-tuned in {time.time() - t0:.1f}s")
            cells[-1]["mesh_tuned"] = mt
            selected_table[scn.name] = (mt["proxy_metrics"]
                                        if mt["selected"] == "mesh-tuned"
                                        else proxy_m)
    if _rank() != 0:
        return pb, None

    trend = None
    if len(cells) >= 2:
        trend = trend_consistency(real_table, proxy_table,
                                  scenarios=[s.name for s in scenarios])
        say(f"  trend: sign={trend['mean_sign_agreement']:.2f} "
            f"rank={trend['mean_rank_agreement']:.2f}")
    trend_mt = None
    if tune_under_mesh and len(selected_table) >= 2:
        multi = [s.name for s in scenarios if s.name in selected_table]
        trend_mt = trend_consistency(
            {k: real_table[k] for k in multi}, selected_table,
            scenarios=multi)
        say(f"  trend (mesh-tuned): "
            f"sign={trend_mt['mean_sign_agreement']:.2f} "
            f"rank={trend_mt['mean_rank_agreement']:.2f}")
    return pb, {"workload": name, "proxy_json": pb.to_json(),
                "per_scenario": cells, "trend": trend,
                "trend_mesh_tuned": trend_mt}


def parity_check(pb, single):
    """1-device scenario == the engine-independent serial path, bit for
    bit (profile-derived metrics only: walls are measured, never
    replayed).  ``single`` is the run=False single-scenario session."""
    serial = serial_evaluate_batch([pb], run=False, lifted=True,
                                   device=single.device)[0]
    return single.evaluate(pb) == serial


def substrate_parity(pb, mesh, device, seed=0) -> Dict[str, Any]:
    """The proxy's eval-form outputs on ``mesh`` with every node on the
    kernels (``"hopper"``) against the stock ATen form on the same mesh:
    the largest absolute difference of the float outputs
    (``rtol=atol=1e-3``), integer outputs (sorts, indices) exact.  Every
    rank of the mesh calls this; the result is the whole tensors'."""
    outs = {}
    for sub in ("torch", "hopper"):
        q = quantize_proxy(pb.with_substrate(sub), mesh)
        fn = q.build_eval_fn(device)
        with use_mesh(mesh):
            res = fn(seed, q.lifted_values(device))
            outs[sub] = {f"{k}.{leaf}": whole(v).cpu()
                         for k, tree in res.items()
                         for leaf, v in _leaves(tree)}
    worst, exact = 0.0, True
    for key, a in outs["torch"].items():
        b = outs["hopper"][key]
        if a.dtype.is_floating_point:
            if not torch.allclose(b.double(), a.double(), rtol=1e-3,
                                  atol=1e-3):
                exact = False
            worst = max(worst, float((b.double() - a.double()).abs().max())
                        if a.numel() else 0.0)
        elif not torch.equal(b.to(torch.int64), a.to(torch.int64)):
            exact = False
    return {"ok": exact, "max_abs_err": worst, "outputs": len(outs["torch"])}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, torch.Tensor):
        yield prefix.rstrip("."), tree


def population_bench(pb, n, mesh_scn, device, iters=3, seed=0):
    """Same candidate batch: one rank vs split across the scenario mesh's
    ranks (population-parallel tuning).  Every rank calls this; rank 0
    runs the one-rank side while the mesh's other ranks wait at a
    barrier, as the reference times it alone, one side after the other;
    a second barrier then starts the sharded side on every rank at
    once."""
    pop = [pb.with_node(pb.nodes[0].id, weight=float(i % 5 + 1),
                        sparsity=0.1 * (i % 3))
           for i in range(n)]
    mesh = mesh_scn.mesh(device.type)
    group = mesh_group(mesh) if in_mesh(mesh) else None
    if group is not None:
        dist.barrier(group=group)
    single = None
    if _rank() == 0:
        single = EvalSession(run=True, seed=seed,
                             device=device).population_runtime(
            pop, iters=iters)
    if group is not None:
        dist.barrier(group=group)
    sharded = None
    if group is not None:
        sharded = EvalSession(run=True, seed=seed, device=device,
                              mesh=mesh).population_runtime(pop, iters=iters)
    if _rank() != 0:
        return None
    out = {"candidates": n, "classes": single["classes"],
           "single_wall_s": single["wall_time"],
           "sharded_wall_s": sharded["wall_time"],
           "sharded_devices": sharded["devices"],
           "speedup": single["wall_time"] / max(sharded["wall_time"], 1e-12)}
    say(f"[scenario_matrix] population bench: {n} candidates, "
        f"1-dev {out['single_wall_s']:.3f}s vs "
        f"{out['sharded_devices']}-dev {out['sharded_wall_s']:.3f}s "
        f"({out['speedup']:.2f}x)")
    return out


def _rank_record(device) -> Dict[str, Any]:
    """This rank's kernel launches and device-memory peak."""
    from repro_torch.kernels.ops import launch_counts

    rec: Dict[str, Any] = {"rank": _rank(), "launches": launch_counts()}
    if device.type == "cuda":
        rec["max_allocated_bytes"] = torch.cuda.max_memory_allocated(device)
        rec["max_reserved_bytes"] = torch.cuda.max_memory_reserved(device)
    return rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--workloads", default=None)
    ap.add_argument("--scenarios", default=",".join(DEFAULT_SCENARIOS))
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--no-run", action="store_true")
    ap.add_argument("--pop", type=int, default=32)
    ap.add_argument("--tune-under-mesh", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--out", default="results/scenario_matrix.json")
    ap.add_argument("--store", default=None,
                    help="persistent ProxyStore directory shared by every "
                         "scenario session (the key carries the mesh)")
    ap.add_argument("--trace", default=None,
                    help="export rank 0's telemetry as Chrome trace JSON")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--substrate", default="torch", choices=SUBSTRATES,
                    help="hopper: the proxies' hot loops on the kernels")
    ap.add_argument("--timeout", type=float, default=3000.0,
                    help="seconds the ranks this entry point starts may "
                         "take together")
    return ap.parse_args(argv)


def run(args) -> int:
    """The sweep on this rank of an initialised process group (or alone
    without one)."""
    hub = None
    if args.trace and _rank() == 0:
        from repro_torch.runtime.telemetry import Telemetry, set_default

        hub = Telemetry()
        set_default(hub)

    dev = resolve_device(args.device)
    run_ = not args.no_run
    scale = args.scale if args.scale is not None else (
        0.02 if args.quick else 0.2)
    iters = args.iters if args.iters is not None else (2 if args.quick else 8)
    if args.workloads:
        names = (sorted(WORKLOADS) if args.workloads == "all"
                 else args.workloads.split(","))
    else:
        names = list(QUICK_WORKLOADS) if args.quick else sorted(WORKLOADS)

    scenarios, scenario_records = resolve_scenarios(
        [s for s in args.scenarios.split(",") if s], dev)
    if not scenarios:
        print("[scenario_matrix] no usable scenarios", file=sys.stderr)
        return 2
    world = dist.get_world_size() if dist.is_initialized() else 1
    say(f"[scenario_matrix] {world} ranks on {dev}; scenarios: "
        f"{[s.name for s in scenarios]}; workloads: {names}")

    # one EvalSession per scenario this rank belongs to, for the whole
    # sweep, plus rank 0's tuning and parity sessions (no mesh)
    store = ProxyStore(args.store) if args.store else None
    sessions = {}
    for scn in scenarios:
        mesh = scn.mesh(dev.type)
        on = in_mesh(mesh) if mesh is not None else _rank() == 0
        if on:
            sessions[scn.name] = EvalSession(
                run=run_, seed=0, mesh=mesh, store=store, device=dev,
                substrate=args.substrate)
    tuning_session = parity_single = None
    if _rank() == 0:
        tuning_session = EvalSession(run=run_, seed=0, store=store,
                                     device=dev, substrate=args.substrate)
        parity_single = EvalSession(run=False, seed=0, device=dev,
                                    mesh=get_scenario("single").mesh())

    doc: Dict[str, Any] = {"devices": world, "scenarios": scenario_records,
                           "workloads": [], "parity": {}}
    failures: List[str] = []
    proxies: Dict[str, ProxyBenchmark] = {}
    multi_usable = [s.name for s in scenarios if s.device_count > 1]
    dp2 = next((s for s in scenarios if s.name == "dp2"), None)
    for name in names:
        pb, rec = run_workload(name, scenarios, sessions, scale, iters,
                               run_, tuning_session=tuning_session,
                               tune_under_mesh=args.tune_under_mesh)
        proxies[name] = pb
        if args.substrate == "hopper" and dp2 is not None:
            mesh = dp2.mesh(dev.type)
            if in_mesh(mesh):
                par = substrate_parity(pb, mesh, dev)
                if _rank() == 0:
                    doc.setdefault("substrate_parity", {})[name] = {
                        "scenario": dp2.name, **par}
                    say(f"  hopper vs torch on dp2: ok={par['ok']} "
                        f"max_abs_err={par['max_abs_err']:.3g}")
                    if not par["ok"]:
                        failures.append(
                            f"{name}/dp2: hopper outputs differ from the "
                            f"stock form's (max abs err "
                            f"{par['max_abs_err']:.3g})")
        if _rank() != 0:
            continue
        doc["workloads"].append(rec)
        ok = parity_check(pb, parity_single)
        doc["parity"][name] = {"bit_identical": ok}
        if not ok:
            failures.append(f"{name}: 1-device scenario metrics diverge "
                            f"from the serial engine path")
        _check_cells(name, rec, failures, args.tune_under_mesh,
                     multi_usable)

    multi = [s for s in scenarios if s.device_count > 1]
    if args.pop and multi and proxies:
        widest = max(multi, key=lambda s: s.device_count)
        pop = population_bench(proxies[names[0]], args.pop, widest, dev)
        if _rank() == 0:
            doc["population_bench"] = pop
            if pop["speedup"] <= 1.0:
                failures.append(
                    f"population bench: {widest.device_count}-device "
                    f"sharding slower than 1 device "
                    f"({pop['speedup']:.2f}x)")

    ranks = _gather(_rank_record(dev))
    if _rank() != 0:
        return 0
    # rank 0 is in every scenario's mesh: it holds every session
    doc["session"] = {
        scn.name: {"stats": sessions[scn.name].stats(),
                   "per_workload": {k: dict(v) for k, v in
                                    sessions[scn.name].workload_stats.items()}}
        for scn in scenarios}
    doc["ranks"] = ranks

    if hub is not None:
        n_events = hub.export_trace(args.trace)
        snap = hub.snapshot()
        doc["trace"] = {"path": args.trace, "events": n_events,
                        "spans_dropped": snap.get("spans_dropped", 0),
                        "span_names": sorted(snap.get("spans", {}))}
        say(f"[scenario_matrix] trace -> {args.trace} ({n_events} events)")

    doc["check_failures"] = failures
    write_json(args.out, doc)
    say(f"[scenario_matrix] wrote {args.out}")
    _print_tables(doc, scenarios, args.tune_under_mesh)

    if args.check and failures:
        print("\n[scenario_matrix] CHECK FAILURES:", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
        return 1
    if failures:
        print("\n[scenario_matrix] warnings (no --check):")
        for f in failures:
            print(f"  - {f}")
    return 0


def _check_cells(name, rec, failures, tune_under_mesh, multi_usable):
    """The reference's per-workload ``--check`` gates."""
    for cell in rec["per_scenario"]:
        scn = get_scenario(cell["scenario"])
        if scn.device_count > 1 and cell["proxy_collective_bytes"] <= 0:
            failures.append(f"{name}/{scn.name}: zero proxy collective "
                            f"bytes on a {scn.device_count}-device mesh")
        if scn.device_count > 1 and cell["real_collective_bytes"] <= 0:
            failures.append(f"{name}/{scn.name}: zero real-workload "
                            f"collective bytes")
        mt = cell.get("mesh_tuned")
        if mt is not None:
            if mt["qualification_rate"] < 1.0:
                failures.append(
                    f"{name}/{scn.name}: mesh-tuned qualification rate "
                    f"{mt['qualification_rate']:.3f} < 1.0 — the tuner "
                    f"scored a candidate quantize_proxy would alter")
            # recompute the selected accuracy from the selection made, so
            # a wrong pick or label fails
            sel_acc = (mt["mean_accuracy"] if mt["selected"] == "mesh-tuned"
                       else cell["mean_accuracy"])
            if sel_acc != mt["selected_accuracy"]:
                failures.append(
                    f"{name}/{scn.name}: selected_accuracy bookkeeping "
                    f"({mt['selected_accuracy']:.3f}) disagrees with the "
                    f"{mt['selected']} pick ({sel_acc:.3f})")
            if sel_acc < cell["mean_accuracy"]:
                failures.append(
                    f"{name}/{scn.name}: mesh-tuned selection regressed "
                    f"accuracy ({sel_acc:.3f} < "
                    f"{cell['mean_accuracy']:.3f} mesh-blind)")
    if tune_under_mesh and len(multi_usable) >= 2:
        tmt = rec.get("trend_mesh_tuned")
        if tmt is None:
            failures.append(
                f"{name}: no trend_mesh_tuned block despite "
                f"{len(multi_usable)} multi-device scenarios")
        else:
            if set(tmt["scenarios"]) != set(multi_usable):
                failures.append(
                    f"{name}: trend_mesh_tuned covers "
                    f"{tmt['scenarios']}, expected {multi_usable}")
            sign = tmt["mean_sign_agreement"]
            rank = tmt["mean_rank_agreement"]
            if not (0.0 <= sign <= 1.0) or not (-1.0 <= rank <= 1.0):
                failures.append(
                    f"{name}: trend_mesh_tuned scores out of range "
                    f"(sign={sign}, rank={rank})")


def _print_tables(doc, scenarios, tune_under_mesh) -> None:
    print("\n=== scenario matrix (paper §III-D / §III-E analog) ===")
    hdr = f"{'workload':14s}" + "".join(
        f"{s.name:>12s}" for s in scenarios) + f"{'sign':>7s}{'rank':>7s}"
    print(hdr)
    for rec in doc["workloads"]:
        accs = "".join(f"{c['mean_accuracy']:12.1%}"
                       for c in rec["per_scenario"])
        t = rec["trend"] or {}
        print(f"{rec['workload']:14s}{accs}"
              f"{t.get('mean_sign_agreement', float('nan')):7.2f}"
              f"{t.get('mean_rank_agreement', float('nan')):7.2f}")
    if tune_under_mesh:
        print("\n=== per-scenario re-tune (--tune-under-mesh) ===")
        print(f"{'workload':14s}{'scenario':>12s}{'blind':>9s}{'tuned':>9s}"
              f"{'delta':>9s}{'qual':>6s}  selected")
        for rec in doc["workloads"]:
            for c in rec["per_scenario"]:
                mt = c.get("mesh_tuned")
                if mt is None:
                    continue
                print(f"{rec['workload']:14s}{c['scenario']:>12s}"
                      f"{c['mean_accuracy']:9.1%}{mt['mean_accuracy']:9.1%}"
                      f"{mt['accuracy_delta']:+9.1%}"
                      f"{mt['qualification_rate']:6.2f}  {mt['selected']}")
            tmt = rec.get("trend_mesh_tuned")
            if tmt is not None:
                print(f"{rec['workload']:14s}{'(trend)':>12s}  "
                      f"sign={tmt['mean_sign_agreement']:.2f} "
                      f"rank={tmt['mean_rank_agreement']:.2f} over "
                      f"{','.join(tmt['scenarios'])}")


def _rank_main(argv) -> int:
    return run(parse_args(argv))


def main(argv=None) -> int:
    """Run the sweep.  Inside a process group every rank calls this;
    without one it starts ``REPRO_EMU_DEVICES`` ranks (default 4) and
    returns rank 0's exit code."""
    args = parse_args(argv)
    if dist.is_available() and dist.is_initialized():
        return run(args)
    from repro_torch.distributed.launch import spawn

    n = int(os.environ.get(EMU_DEVICES_ENV, "4"))
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
