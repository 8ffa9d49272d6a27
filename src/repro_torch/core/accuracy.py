"""Accuracy evaluation — the paper's Eq. 3 and the metric vector M (port of
``repro/core/accuracy.py``, framework-free).

Eq. 3:  Accuracy(Val_R, Val_P) = 1 - |Val_P - Val_R| / Val_R, in [0, 1].

The paper's M is made of *rates and mixes* (IPC, MIPS, hit ratios,
bandwidths) — size-invariant quantities, which is what lets a proxy be
100s x faster yet >90% accurate.  The port normalises its profiled
signature the same way as the reference:

| paper metric            | analog (this vector)                          |
|-------------------------|-----------------------------------------------|
| IPC / MIPS              | flops_rate, bytes_rate (when wall-time known) |
| instruction mix         | op-class byte mix (dot/conv/ew/logic/...)     |
| cache hit ratios        | arith_intensity (FLOPs per device byte)       |
| memory bandwidth        | bytes_rate                                    |
| disk I/O bandwidth      | collective byte fractions (multi-device runs) |
| branch miss             | transcendental + logic fraction               |
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.core.signature import Signature

#: metrics used for tuning/accuracy by default (all size-invariant)
DEFAULT_METRICS: Tuple[str, ...] = (
    "arith_intensity",
    "mix_dot", "mix_conv", "mix_elementwise", "mix_logic",
    "mix_reduce", "mix_data_movement", "mix_sort",
    "transcendental_frac", "dot_flops_frac",
)

#: metrics appended when wall-time measurements exist
RATE_METRICS: Tuple[str, ...] = ("flops_rate", "bytes_rate")

#: per-kind collective-byte fractions (collective kind -> metric name) —
#: the paper's network/disk-I/O bandwidth analog.  Present in the vector
#: only for a multi-device profile; single-device vectors are untouched.
COLLECTIVE_KIND_FRACS: Tuple[Tuple[str, str], ...] = (
    ("all-reduce", "coll_all_reduce_frac"),
    ("all-gather", "coll_all_gather_frac"),
    ("reduce-scatter", "coll_reduce_scatter_frac"),
    ("all-to-all", "coll_all_to_all_frac"),
    ("collective-permute", "coll_permute_frac"),
)

#: collective metric names eligible for feature selection, total first
COLLECTIVE_METRICS: Tuple[str, ...] = (
    ("coll_frac",) + tuple(name for _, name in COLLECTIVE_KIND_FRACS))


def normalized_vector(sig: Signature,
                      include_rates: bool = True) -> Dict[str, float]:
    """Size-invariant metric vector M from a signature."""
    v = sig.vector()
    out = {k: v[k] for k in DEFAULT_METRICS if k in v}
    out["transcendental_frac"] = sig.transcendentals / max(sig.flops, 1.0)
    out["dot_flops_frac"] = sig.dot_flops / max(sig.flops, 1.0)
    coll_total = sum(sig.collective_bytes.values())
    if coll_total > 0:
        out["coll_frac"] = coll_total / max(sig.bytes, 1.0)
        for kind, name in COLLECTIVE_KIND_FRACS:
            b = sig.collective_bytes.get(kind, 0.0)
            if b > 0:
                out[name] = b / max(sig.bytes, 1.0)
    if include_rates and sig.wall_time:
        out["flops_rate"] = sig.flops / sig.wall_time
        out["bytes_rate"] = sig.bytes / sig.wall_time
    return out


def eq3_accuracy(val_r: float, val_p: float) -> float:
    """Paper Eq. 3, clamped to [0, 1].

    Both-zero counts as perfectly accurate; real-zero with nonzero proxy
    counts as 0 (the paper's |.| can exceed 1; it reports the clamp).
    """
    if val_r == 0.0:
        return 1.0 if val_p == 0.0 else 0.0
    return max(0.0, 1.0 - abs((val_p - val_r) / val_r))


@dataclass(frozen=True)
class AccuracyReport:
    per_metric: Mapping[str, float]
    mean: float
    worst_metric: str
    worst: float

    def passed(self, tol: float = 0.15) -> bool:
        """Paper feedback-stage end condition: every deviation <= tol."""
        return all(a >= 1.0 - tol for a in self.per_metric.values())

    def table(self) -> str:
        lines = [f"{'metric':24s} accuracy"]
        for k, v in sorted(self.per_metric.items()):
            lines.append(f"{k:24s} {v:8.3f}")
        lines.append(f"{'MEAN':24s} {self.mean:8.3f}")
        return "\n".join(lines)


def compare(m_real: Mapping[str, float], m_proxy: Mapping[str, float],
            metrics: Optional[Sequence[str]] = None) -> AccuracyReport:
    """Eq. 3 per metric + average (the paper's Fig. 4 quantity)."""
    keys = list(metrics) if metrics else [k for k in m_real if k in m_proxy]
    per = {k: eq3_accuracy(float(m_real[k]), float(m_proxy.get(k, 0.0)))
           for k in keys}
    if not per:
        return AccuracyReport({}, 0.0, "", 0.0)
    worst = min(per, key=per.get)
    return AccuracyReport(per, sum(per.values()) / len(per), worst, per[worst])


def deviations(m_real: Mapping[str, float],
               m_proxy: Mapping[str, float],
               metrics: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Relative deviation per metric (the tuner's feedback signal)."""
    keys = list(metrics) if metrics else [k for k in m_real if k in m_proxy]
    out = {}
    for k in keys:
        r, p = float(m_real[k]), float(m_proxy.get(k, 0.0))
        if r == 0.0:
            out[k] = 0.0 if p == 0.0 else 1.0
        else:
            out[k] = abs(p - r) / abs(r)
    return out
