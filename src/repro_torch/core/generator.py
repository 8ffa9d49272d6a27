"""End-to-end proxy-benchmark generation (paper Fig. 1 / Fig. 3); port of
``repro/core/generator.py``.

``generate_proxy(workload_fn, *args)``:
1. profile the real workload (+ run it) -> target Signature;
2. *decompose* into motifs with share-seeded weights (+hints);
3. *feature select* the metric vector M;
4. *tune* with the decision tree until all deviations <= tol;
5. return the qualified :class:`ProxyBenchmark` + report (accuracy,
   speedup — the paper's Table VI / Fig. 4 quantities).

``mesh`` tunes the proxy under one cluster scenario
(:mod:`repro_torch.core.cluster`): candidates run sharded, the mesh's
quantize rule rounds every candidate, and the priors see the mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.core.accuracy import (
    COLLECTIVE_METRICS,
    DEFAULT_METRICS,
    RATE_METRICS,
    compare,
    normalized_vector,
)
from repro_torch.core.cluster import make_quantizer
from repro_torch.core.decompose import MotifHint, decompose
from repro_torch.core.evaluator import BatchEvaluator, EvalSession, counter_delta
from repro_torch.core.motifs.base import DEFAULT_EVAL_CACHE, SUBSTRATES, PVector
from repro_torch.core.priors import PriorTable, elasticity_priors, seed_num_tasks
from repro_torch.core.proxy_graph import ProxyBenchmark
from repro_torch.core.signature import Signature, signature_of_call
from repro_torch.core.tuner import DecisionTreeTuner, TuneResult
from repro_torch.device import DeviceLike, resolve_device


@dataclass
class ProxyReport:
    name: str
    qualified: bool
    mean_accuracy: float
    per_metric_accuracy: Mapping[str, float]
    real_wall_time: Optional[float]
    proxy_wall_time: Optional[float]
    speedup: Optional[float]
    iterations: int
    evals: int
    tree_depth: int
    target_metrics: Mapping[str, float]
    proxy_metrics: Mapping[str, float]
    trace: Sequence[Any] = field(default_factory=list)
    engine_stats: Mapping[str, int] = field(default_factory=dict)
    qualification_rate: float = 1.0
    device: str = ""
    #: True when the tuner ran with an elasticity-prior table
    prior_seeded: bool = False
    #: how each wall time was taken (``Signature.timing``): a captured
    #: CUDA graph's replays, or eager dispatch and why
    real_timing: Mapping[str, str] = field(default_factory=dict)
    proxy_timing: Mapping[str, str] = field(default_factory=dict)

    def summary(self) -> str:
        sp = f"{self.speedup:.0f}x" if self.speedup else "n/a"
        return (f"[{self.name}] qualified={self.qualified} "
                f"mean_acc={self.mean_accuracy:.1%} speedup={sp} "
                f"iters={self.iterations} evals={self.evals} "
                f"device={self.device}")


def proxy_signature(pb: ProxyBenchmark, *, run: bool = True, seed: int = 0,
                    iters: int = 5, form: str = "eval",
                    device: DeviceLike = None) -> Signature:
    """Signature of the whole proxy DAG.

    ``form="eval"`` (default) profiles the eval form the evaluator
    profiles, so it reproduces the engine's metrics.  ``form="static"``
    is the fully baked program: equal outputs, but not equal metrics (the
    lifted knobs' masks and multiplies run only in the eval form)."""
    dev = resolve_device(device)
    if form == "eval":
        return signature_of_call(pb.build_eval_fn(dev), seed,
                                 pb.lifted_values(dev), run=run, iters=iters)
    if form != "static":
        raise ValueError(f"unknown form {form!r}; want 'eval' or 'static'")
    return signature_of_call(pb.build_fn(dev), seed, run=run, iters=iters,
                             device=dev)


def proxy_metrics(pb: ProxyBenchmark, *, run: bool = True,
                  metrics: Optional[Sequence[str]] = None, seed: int = 0,
                  form: str = "eval",
                  device: DeviceLike = None) -> Dict[str, float]:
    sig = proxy_signature(pb, run=run, seed=seed, form=form, device=device)
    m = normalized_vector(sig, include_rates=run)
    if metrics is not None:
        m = {k: m.get(k, 0.0) for k in metrics}
    return m


def select_metrics(target: Mapping[str, float],
                   include_rates: bool) -> Sequence[str]:
    """Feature selecting (paper §II-B2): keep informative metrics only.
    Mix fractions that are ~0 in the target are dropped."""
    keep = []
    for k in DEFAULT_METRICS + COLLECTIVE_METRICS:
        v = target.get(k)
        if v is None:
            continue
        if k.startswith("mix_") and v < 0.02:
            continue
        if k.endswith("_frac") and v < 1e-3:
            continue
        keep.append(k)
    if include_rates:
        keep += [k for k in RATE_METRICS if target.get(k)]
    return keep


def _check_args_device(args, dev: torch.device) -> None:
    """Every tensor of the arguments' pytree (a params dict included) must
    lie on the proxy's device type."""
    for a in tree_leaves(args):
        if isinstance(a, torch.Tensor) and a.device.type != dev.type:
            raise ValueError(f"workload argument on {a.device}, but the "
                             f"proxy runs on {dev}")


def generate_proxy(
    workload_fn: Callable[..., Any],
    *args: Any,
    name: str = "proxy",
    hints: Optional[Sequence[MotifHint]] = None,
    base_p: Optional[PVector] = None,
    tol: float = 0.15,
    max_iters: int = 24,
    run: bool = True,
    target_signature: Optional[Signature] = None,
    seed: int = 0,
    evaluator: Optional[BatchEvaluator] = None,
    session: Optional[EvalSession] = None,
    cache_capacity: int = DEFAULT_EVAL_CACHE,
    compile_workers: Optional[int] = None,
    mesh: Any = None,
    priors: Any = None,
    substrate: Optional[str] = None,
    device: DeviceLike = None,
) -> tuple[ProxyBenchmark, ProxyReport]:
    """The paper's full methodology, one call, on ``device`` (CUDA unless
    the caller passes ``device="cpu"``).

    ``run=False`` tunes on profiled metrics only (no timing).
    ``substrate="hopper"`` lowers the sort/matrix/statistics hot loops
    onto the hand-written kernels for every candidate the tuner scores;
    ``"torch"`` keeps the stock ATen forms; ``None`` inherits a session's
    ``substrate``, else ``"torch"``.

    ``session`` (an :class:`EvalSession`) shares one engine across several
    calls: the paper-repro sweep warm-starts each workload from the
    earlier ones' profiles, and the session records this call's traffic
    under ``name``.  ``evaluator`` (mutually exclusive) shares a bare
    engine with no per-workload accounting.  Either must run on
    ``device`` with this call's ``run`` and ``seed``.

    ``compile_workers`` sizes the profiling pool of the engine this call
    builds (``None``: auto, see :class:`BatchEvaluator`).

    ``mesh`` tunes the proxy under a cluster scenario: candidates run
    sharded over the mesh (a ``DeviceMesh``), so collective-byte
    fractions join the tunable signature; a target profiled under the
    same scenario (:func:`repro_torch.core.cluster.workload_signature`,
    passed as ``target_signature``) seeds collective fractions into the
    decomposition, and the mesh's quantize rule
    (:func:`repro_torch.core.cluster.make_quantizer`) rounds every
    candidate the tuner scores, so ``report.qualification_rate`` is 1.0.
    With a shared ``session``/``evaluator`` the engine's own mesh wins
    and must agree; a mesh-bound session's mesh drives the quantize rule
    even when ``mesh`` is ``None``.  Every rank of the mesh runs this
    call in step.

    ``priors`` seeds the adjusting stage with analytic elasticities
    (:mod:`repro_torch.core.priors`): ``True`` derives the table from the
    decomposed proxy (and, under a mesh, seeds each node's ``num_tasks``
    from the mesh's axis sizes); a :class:`PriorTable` is used as-is;
    ``None`` inherits a session's ``priors`` flag, else runs the
    cold-start loop.
    """
    dev = resolve_device(device)
    if session is not None and evaluator is not None:
        raise ValueError("pass either session or evaluator, not both")
    if session is not None:
        evaluator = session  # quacks like a BatchEvaluator
    if evaluator is not None:
        if evaluator.device != dev:
            raise ValueError(f"evaluator runs on {evaluator.device}, this "
                             f"call wants {dev}")
        if mesh is not None and getattr(evaluator, "mesh", None) != mesh:
            # equality, not identity: equal meshes partition identically
            raise ValueError(
                "mesh= disagrees with the shared evaluator/session's mesh; "
                "build the EvalSession with mesh=... instead")
        if evaluator.run != run or evaluator.seed != seed:
            raise ValueError(
                f"shared evaluator was built with run={evaluator.run}, "
                f"seed={evaluator.seed}; this call wants run={run}, "
                f"seed={seed}")
    if substrate is None:
        substrate = getattr(evaluator, "substrate", None)
    if substrate is not None and substrate not in SUBSTRATES:
        raise ValueError(
            f"unknown substrate {substrate!r}; choose from {SUBSTRATES}")
    _check_args_device(args, dev)

    # 1. profile the real workload ------------------------------------------
    if target_signature is None:
        target_signature = signature_of_call(workload_fn, *args, run=run)
    target = normalized_vector(target_signature, include_rates=run)

    # 2. decompose ------------------------------------------------------------
    # the span lands on the shared engine's hub; with none shared,
    # decompose resolves the process default itself
    pb0 = decompose(target_signature, hints=hints, base_p=base_p, name=name,
                    telemetry=getattr(evaluator, "telemetry", None))
    if substrate is not None and substrate != "torch":
        pb0 = pb0.with_substrate(substrate)

    # 3. feature selecting ----------------------------------------------------
    metric_names = select_metrics(target, include_rates=run)
    target_sel = {k: target.get(k, 0.0) for k in metric_names}

    # 4. decision-tree tuning -------------------------------------------------
    if evaluator is None:
        evaluator = BatchEvaluator(run=run, seed=seed,
                                   capacity=cache_capacity,
                                   compile_workers=compile_workers,
                                   device=dev, mesh=mesh)
    # the effective scenario mesh: the argument, else the engine's; its
    # rounding rule (under the engine's rule table) goes to the tuner
    eff_mesh = mesh if mesh is not None else getattr(evaluator, "mesh", None)
    quantize = make_quantizer(eff_mesh, getattr(evaluator, "rules", None))
    if priors is None:
        priors = bool(getattr(evaluator, "priors", False))
    prior_table: Optional[PriorTable] = None
    if priors is True:
        pb0 = seed_num_tasks(pb0, eff_mesh)  # identity without a mesh
        prior_table = elasticity_priors(pb0, metric_names, mesh=eff_mesh)
    elif priors:
        prior_table = priors
    stats_before = evaluator.stats()
    saved_metrics = evaluator.metrics
    evaluator.metrics = list(metric_names)
    scope = (session.workload(name) if session is not None
             else contextlib.nullcontext())
    try:
        with scope:
            tuner = DecisionTreeTuner(evaluator, target_sel, tol=tol,
                                      max_iters=max_iters, seed=seed,
                                      priors=prior_table, quantize=quantize)
            result: TuneResult = tuner.tune(pb0)
            # the final report reuses this workload's cached profiles, so
            # it belongs inside the workload scope
            final_sig = evaluator.signature_of(result.proxy)
    finally:
        evaluator.metrics = saved_metrics

    # 5. report -----------------------------------------------------------------
    final_m = normalized_vector(final_sig, include_rates=run)
    rep = compare(target_sel, final_m, metric_names)
    speedup = None
    if run and target_signature.wall_time and final_sig.wall_time:
        speedup = target_signature.wall_time / final_sig.wall_time

    report = ProxyReport(
        name=name,
        qualified=result.qualified,
        mean_accuracy=rep.mean,
        per_metric_accuracy=rep.per_metric,
        real_wall_time=target_signature.wall_time,
        proxy_wall_time=final_sig.wall_time,
        speedup=speedup,
        iterations=result.iterations,
        evals=result.evals,
        tree_depth=result.tree_depth,
        target_metrics=target_sel,
        proxy_metrics={k: final_m.get(k, 0.0) for k in metric_names},
        trace=result.trace,
        # this call's traffic, not the shared engine's lifetime
        engine_stats=counter_delta(stats_before, evaluator.stats()),
        qualification_rate=result.qualification_rate,
        device=str(dev),
        prior_seeded=result.prior_seeded,
        real_timing=dict(target_signature.timing),
        proxy_timing=dict(final_sig.timing),
    )
    qualified = dataclasses.replace(
        result.proxy,
        meta={**dict(result.proxy.meta), "qualified": result.qualified,
              "mean_accuracy": rep.mean})
    return qualified, report
