"""Cluster scenarios — the mesh-shape arithmetic of the paper's "changing
cluster configurations" axis (§III-D) and its trend-consistency score
(§III-E); port of the pure parts of ``repro/core/cluster.py``.

A mesh is read only through its axis names and per-axis sizes
(:func:`repro_torch.distributed.sharding.mesh_axes`): a
``torch.distributed.device_mesh.DeviceMesh`` or a stand-in such as
:class:`~repro_torch.distributed.sharding.MeshShape`.  From them come:

* :func:`mesh_structural_key`, a mesh's part of a cache key;
* the divisibility quanta (:func:`axis_quantum`, :func:`batch_quantum`,
  :func:`model_quantum`, :func:`mesh_task_quantum`);
* the tuner's candidate-rounding rule (:func:`quantize_proxy`,
  :func:`make_quantizer`), which rounds the ``QUANTIZED_FIELDS`` up to
  the batch quantum;
* :func:`trend_consistency`: do proxy metrics move the way real metrics
  move across scenarios?

Not ported yet (they need real sharded execution): ``ClusterScenario``,
``SCENARIOS``, ``shrink_scenario``, ``shard_args`` and
``workload_signature``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.distributed.sharding import ShardingRules, mesh_axes


class ClusterError(ValueError):
    """Bad scenario definition or scenario/host mismatch."""


# ---------------------------------------------------------------------------
# Mesh identity for the executable cache
# ---------------------------------------------------------------------------


def mesh_structural_key(mesh) -> Optional[Tuple]:
    """The mesh's contribution to the executable-cache key, or ``None``.

    Two meshes with equal keys partition a program identically: only the
    axis names and the per-axis sizes count, never which device backs
    which coordinate.  ``None`` (no mesh) yields ``None``."""
    if mesh is None:
        return None
    axes = mesh_axes(mesh)
    return ("__mesh__", tuple(a for a, _ in axes),
            tuple(n for _, n in axes))


def axis_quantum(mesh, logical: str,
                 rules: Optional[ShardingRules] = None) -> int:
    """Number of ways the logical axis ``logical`` splits on ``mesh``: the
    product of the sizes of every mesh axis the rule table maps it onto
    and that is present on the mesh.  1 for no mesh, and 1 for a logical
    axis whose mapped mesh axes are all absent."""
    if mesh is None:
        return 1
    rules = rules or ShardingRules()
    sizes = dict(mesh_axes(mesh))
    q = 1
    for a in rules.mesh_axes_for(logical, mesh):
        q *= sizes[a]
    return q


def batch_quantum(mesh, rules: Optional[ShardingRules] = None) -> int:
    """Number of ways the logical ``batch`` axis splits on ``mesh`` (1 for
    no mesh): the divisibility quantum for data-parallel dims."""
    return axis_quantum(mesh, "batch", rules)


def model_quantum(mesh, rules: Optional[ShardingRules] = None) -> int:
    """Number of ways the logical ``motif_width`` axis splits on ``mesh``:
    the quantum for the proxy's width dims on 2-D ``data x model`` meshes,
    1 on 1-D meshes."""
    return axis_quantum(mesh, "motif_width", rules)


def mesh_task_quantum(mesh) -> int:
    """Total parallel device lanes a mesh offers, the product of its axis
    sizes (1 for no mesh): the ``num_tasks`` seeding quantum.  Unlike
    :func:`batch_quantum` it counts every axis."""
    if mesh is None:
        return 1
    return int(math.prod(n for _, n in mesh_axes(mesh)))


#: P fields subject to mesh quantization: the data-volume dims a cluster
#: scenario shards across its ``batch`` axis.  Every other tunable P
#: entry is free.
QUANTIZED_FIELDS: Tuple[str, ...] = ("data_size", "batch_size")


def quantize_proxy(pb, mesh, rules: Optional[ShardingRules] = None):
    """Round a proxy's ``QUANTIZED_FIELDS`` up to the nearest multiple of
    the mesh's batch quantum (at most ``quantum - 1`` more a field and
    node); every other P entry is untouched.  Identity when ``mesh`` is
    ``None`` or the quantum is 1.  The quantum is axis-aware: on a 2-D
    ``data x model`` mesh it is the data axis alone."""
    q = batch_quantum(mesh, rules)
    if q <= 1:
        return pb
    out = pb
    for node in pb.nodes:
        p = node.p
        updates = {}
        for f in QUANTIZED_FIELDS:
            v = int(getattr(p, f))
            if v % q:
                updates[f] = v + q - v % q
        if updates:
            out = out.with_node(node.id, **updates)
    return out


def make_quantizer(mesh, rules: Optional[ShardingRules] = None):
    """The tuner-facing rounding rule for one mesh: a ``ProxyBenchmark ->
    ProxyBenchmark`` closure over :func:`quantize_proxy`, or ``None``
    when it would be the identity (no mesh, or a 1-way batch quantum), so
    the tuner's no-quantize path stays untouched."""
    if batch_quantum(mesh, rules) <= 1:
        return None
    return lambda pb: quantize_proxy(pb, mesh, rules)


# ---------------------------------------------------------------------------
# Trend consistency (paper §III-D / §III-E)
# ---------------------------------------------------------------------------


def _avg_ranks(vals: np.ndarray) -> np.ndarray:
    """Average ranks (ties share their mean rank) — Spearman's rho input."""
    order = np.argsort(vals, kind="stable")
    ranks = np.empty(len(vals), np.float64)
    i = 0
    while i < len(vals):
        j = i
        while j + 1 < len(vals) and vals[order[j + 1]] == vals[order[i]]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0
        i = j + 1
    return ranks


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    flat_a = bool(np.all(a == a[0]))
    flat_b = bool(np.all(b == b[0]))
    if flat_a or flat_b:
        # both flat: trivially consistent.  Exactly one flat: it does not
        # track the other at all, which scores 0, not "undefined -> 1.0"
        return 1.0 if (flat_a and flat_b) else 0.0
    ra, rb = _avg_ranks(a), _avg_ranks(b)
    va, vb = ra - ra.mean(), rb - rb.mean()
    denom = float(np.sqrt((va * va).sum() * (vb * vb).sum()))
    if denom == 0.0:
        return 0.0
    return float((va * vb).sum() / denom)


def trend_consistency(real: Mapping[str, Mapping[str, float]],
                      proxy: Mapping[str, Mapping[str, float]],
                      scenarios: Optional[Sequence[str]] = None,
                      metrics: Optional[Sequence[str]] = None,
                      rel_eps: float = 0.02) -> Dict[str, Any]:
    """Do proxy metrics move the way real metrics move across scenarios?

    ``real``/``proxy`` map scenario name -> metric vector.  For each
    metric present in both tables across all scenarios: **sign
    agreement**, over consecutive scenario pairs the fraction where the
    real and proxy deltas have the same direction (a delta within
    ``rel_eps`` of the metric's magnitude is flat; flat-vs-flat agrees,
    flat-vs-moving does not), and **rank agreement**, Spearman's rho of
    the scenario orderings the two induce.  Returns per-metric scores
    and their means."""
    names = list(scenarios if scenarios is not None else real.keys())
    if len(names) < 2:
        raise ClusterError("trend consistency needs >= 2 scenarios")
    if metrics is None:
        metrics = sorted(
            set.intersection(*(set(real[s]) for s in names),
                             *(set(proxy[s]) for s in names)))

    def sign(delta: float, base: float) -> int:
        if abs(delta) <= rel_eps * max(abs(base), 1e-12):
            return 0
        return 1 if delta > 0 else -1

    per_metric: Dict[str, Dict[str, float]] = {}
    for m in metrics:
        r = np.asarray([float(real[s][m]) for s in names], np.float64)
        p = np.asarray([float(proxy[s][m]) for s in names], np.float64)
        agree = [
            sign(r[i + 1] - r[i], r[i]) == sign(p[i + 1] - p[i], p[i])
            for i in range(len(names) - 1)
        ]
        per_metric[m] = {
            "sign_agreement": float(np.mean(agree)),
            "rank_agreement": _spearman(r, p),
        }
    if not per_metric:
        raise ClusterError("no shared metrics across the scenario tables")
    return {
        "scenarios": names,
        "per_metric": per_metric,
        "mean_sign_agreement": float(np.mean(
            [v["sign_agreement"] for v in per_metric.values()])),
        "mean_rank_agreement": float(np.mean(
            [v["rank_agreement"] for v in per_metric.values()])),
    }
