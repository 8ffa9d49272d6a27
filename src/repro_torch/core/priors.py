"""Elasticity priors — the adjusting stage's analytic head start (port of
``repro/core/priors.py``).

A per-``(param, metric)`` prior elasticity table derived from the
decomposition itself:

* each motif node's footprint is dominated by one op class
  (``decompose.OPCLASS_TO_MOTIF`` read backwards), so scaling that
  node's byte volume (``weight`` via repeats, ``data_size`` linearly)
  raises its own class's byte mix and dilutes every other class — the
  share derivative ``d log(mix_own) = +(1 - s)``, ``d log(mix_other) =
  -s`` per octave, where ``s`` is the node's estimated byte share;
* under a cluster scenario the same holds for per-kind collective
  fractions through ``decompose.COLLECTIVE_TO_MOTIF``; without a mesh
  those rows say nothing (``None``);
* under a mesh, :func:`seed_num_tasks` seeds every node's ``num_tasks``
  from the mesh's axis sizes.

:class:`repro_torch.core.tuner.DecisionTreeTuner` blends these priors
with observed slopes through the update ``(c * prior + sum(observed)) /
(c + n)``.  Params covered by the prior skip their one-at-a-time
impact-analysis perturbations.  :data:`EMPTY_PRIORS` (no slopes, no
covered params) drives the tuner bit-identically to ``priors=None``.

"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Mapping, Optional, Sequence, Tuple

from repro_torch.core.accuracy import COLLECTIVE_KIND_FRACS
from repro_torch.core.cluster import mesh_task_quantum
from repro_torch.core.decompose import (
    COLLECTIVE_MOTIFS,
    COLLECTIVE_TO_MOTIF,
    OPCLASS_TO_MOTIF,
)
from repro_torch.core.motifs.base import TUNABLE_BOUNDS
from repro_torch.core.proxy_graph import ProxyBenchmark

__all__ = [
    "PRIOR_CONFIDENCE",
    "PRIOR_FIELDS",
    "PRIOR_FAMILIES",
    "EMPTY_PRIORS",
    "PriorTable",
    "elasticity_priors",
    "seed_num_tasks",
]

#: prior pseudo-observation count ``c`` in the tuner's blended update
#: ``elasticity = (c * prior + sum(observed)) / (c + n_observed)``
PRIOR_CONFIDENCE: float = 2.0

#: P fields the prior covers; a covered (node, field) param skips its
#: impact-analysis perturbation
PRIOR_FIELDS: Tuple[str, ...] = ("weight", "data_size")

#: the (param field, metric family) pairs the prior table populates
PRIOR_FAMILIES: Tuple[Tuple[str, str], ...] = (
    ("weight", "mix_*"),
    ("weight", "coll_*_frac"),
    ("weight", "coll_frac"),
    ("weight", "dot_flops_frac"),
    ("weight", "transcendental_frac"),
    ("weight", "arith_intensity"),
    ("weight", "*_rate"),
    ("data_size", "mix_*"),
    ("data_size", "coll_*_frac"),
    ("data_size", "coll_frac"),
    ("data_size", "dot_flops_frac"),
    ("data_size", "transcendental_frac"),
    ("data_size", "arith_intensity"),
    ("data_size", "*_rate"),
)

#: wall-clock-derived metrics: the prior is an explicit zero (scaling a
#: node's load moves the numerator and the wall time together)
RATE_METRICS: Tuple[str, ...] = ("flops_rate", "bytes_rate")

#: slopes are "per octave" (the tuner's feature space is log2)
_LN2 = math.log(2.0)

#: metric name -> collective kind
_FRAC_TO_KIND: Mapping[str, str] = {name: kind
                                    for kind, name in COLLECTIVE_KIND_FRACS}


@dataclass(frozen=True)
class PriorTable:
    """Per-(param label, metric) prior elasticities + their confidence.

    ``slopes[(label, metric)]`` is the prior d log(metric) per octave of
    the param; ``confidence`` is the pseudo-observation count ``c`` of
    the blended update; ``covered`` lists the param labels whose
    impact-analysis perturbations the prior replaces."""

    slopes: Mapping[Tuple[str, str], float] = field(default_factory=dict)
    confidence: float = PRIOR_CONFIDENCE
    covered: FrozenSet[str] = frozenset()

    def __post_init__(self):
        if self.confidence <= 0.0:
            raise ValueError("prior confidence must be > 0 "
                             f"(got {self.confidence})")

    def get(self, label: str, metric: str) -> Optional[float]:
        return self.slopes.get((label, metric))


EMPTY_PRIORS = PriorTable()


def _share_slope(is_own: bool, share: float) -> float:
    """d log(frac_own)/d log(load_n) = 1 - s_n, d log(frac_other)/d
    log(load_n) = -s_n."""
    return (1.0 - share) if is_own else -share


def _prior_slope(fld: str, metric: str, motif: str, share: float,
                 mesh) -> Optional[float]:
    """Prior d log(metric) / d log(param) for one (node field, metric),
    in natural-log units; ``None`` = the prior says nothing."""
    if metric.startswith("mix_"):
        own = OPCLASS_TO_MOTIF.get(metric[len("mix_"):], (None,))[0]
        return _share_slope(motif == own, share)
    if metric == "coll_frac":
        if mesh is None:
            return None
        return _share_slope(motif in COLLECTIVE_MOTIFS, share)
    if metric in _FRAC_TO_KIND:
        if mesh is None:
            return None
        own = COLLECTIVE_TO_MOTIF[_FRAC_TO_KIND[metric]][0]
        return _share_slope(motif == own, share)
    if metric == "dot_flops_frac":
        return _share_slope(motif == "matrix", share)
    if metric == "transcendental_frac":
        return _share_slope(motif == "statistics", share)
    if metric == "arith_intensity":
        # compute-dense motifs: flops grow superlinearly in data volume,
        # bytes linearly -> AI rises with data_size; everything else gets
        # an explicit zero ("no leverage")
        if fld == "data_size" and motif in ("matrix", "transform"):
            return 0.5 * (1.0 - share)
        return 0.0
    if metric in RATE_METRICS:
        return 0.0
    return None


def elasticity_priors(pb: ProxyBenchmark, metrics: Sequence[str],
                      mesh=None,
                      confidence: float = PRIOR_CONFIDENCE) -> PriorTable:
    """Derive the prior table for one decomposed proxy.

    ``metrics`` is the selected metric vector the tuner will close.
    Per-node byte shares are estimated as ``repeats * data_size``.  A
    param is covered only when the table speaks for it on every selected
    metric."""
    loads = {n.id: float(max(n.p.repeats * n.p.data_size, 1))
             for n in pb.nodes}
    total = sum(loads.values()) or 1.0
    slopes: Dict[Tuple[str, str], float] = {}
    covered = set()
    for n in pb.nodes:
        share = loads[n.id] / total
        for fld in PRIOR_FIELDS:
            label = f"{n.id}.{fld}"
            complete = True
            for m in metrics:
                sl = _prior_slope(fld, m, n.motif, share, mesh)
                if sl is None:
                    complete = False
                else:
                    slopes[(label, m)] = sl * _LN2
            if complete:
                covered.add(label)
    return PriorTable(slopes=slopes, confidence=confidence,
                      covered=frozenset(covered))


def seed_num_tasks(pb: ProxyBenchmark, mesh) -> ProxyBenchmark:
    """Seed every node's ``num_tasks`` from the mesh's axis sizes.

    A scenario with N device lanes (``mesh_task_quantum``, the product of
    the mesh's axis sizes) wants at least N task lanes a motif, in whole
    multiples so each device receives complete lanes.  The identity
    without a mesh or when every node already meets the quantum; clamped
    to the ``num_tasks`` tunable bounds."""
    q = mesh_task_quantum(mesh)
    if q <= 1:
        return pb
    lo, hi = TUNABLE_BOUNDS["num_tasks"]
    out = pb
    for node in pb.nodes:
        nt = int(node.p.num_tasks)
        seeded = max(-(-nt // q) * q, q)       # round up to a q multiple
        seeded = int(min(max(seeded, lo), hi))
        if seeded != nt:
            out = out.with_node(node.id, num_tasks=seeded)
    return out
