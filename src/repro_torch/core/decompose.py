"""Benchmark decomposing (paper §II-B1): workload -> motifs + initial
weights (port of ``repro/core/decompose.py``).

The profiled op classes are the workload's profile: each class is the
footprint of one motif (dot->Matrix, conv->Transform, sort->Sort, ...);
the per-class share of total work seeds the motif weight — the paper's
"weight proportional to execution ratio".  An optional hint list (the
Table III bottom-up analysis analog) restricts which motifs a workload
decomposes into and names the variant per motif.

A target profiled over several devices carries per-kind collective
bytes; each kind is credited to the motif ``COLLECTIVE_TO_MOTIF`` names.
A zero-collective target (every single-device profile) never reaches
that code.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.motifs.base import PVector
from repro_torch.core.proxy_graph import MotifNode, ProxyBenchmark
from repro_torch.core.signature import Signature

# op class -> (motif, default variant)
OPCLASS_TO_MOTIF: Mapping[str, Tuple[str, str]] = {
    "dot": ("matrix", "matmul"),
    "conv": ("transform", "conv2d"),
    "sort": ("sort", "quick"),
    "reduce": ("statistics", "average"),
    "data_movement": ("sampling", "random"),
    "logic": ("logic", "bitops"),
    "elementwise": ("statistics", "softmax"),
}

# collective kind -> (motif, default variant): which motif's sharded
# footprint each collective class is
COLLECTIVE_TO_MOTIF: Mapping[str, Tuple[str, str]] = {
    "all-reduce": ("statistics", "average"),
    "all-gather": ("sort", "quick"),
    "reduce-scatter": ("matrix", "matmul"),
    "all-to-all": ("sampling", "random"),
    "collective-permute": ("graph", "traversal"),
    "collective-broadcast": ("graph", "traversal"),
}

#: motifs whose sharded form emits any collective kind at all
#: (``COLLECTIVE_TO_MOTIF`` read backwards); the elasticity priors resolve
#: the "own motif" of the total ``coll_frac`` metric through it
COLLECTIVE_MOTIFS = frozenset(m for m, _ in COLLECTIVE_TO_MOTIF.values())


@dataclass(frozen=True)
class MotifHint:
    """One Table III row: a motif the workload is known to contain."""

    motif: str
    variant: str = ""
    weight: Optional[float] = None     # None -> seed from the op-class share
    p_overrides: Mapping[str, object] = None  # type: ignore[assignment]

    def overrides(self) -> Dict[str, object]:
        return dict(self.p_overrides or {})


def hlo_shares(sig: Signature) -> Dict[str, float]:
    """Work share per op class (flops-weighted where flops exist, else
    bytes).  The name is the reference's; the classes come from the ATen
    profile here."""
    shares: Dict[str, float] = {}
    total_flops = max(sig.flops, 1.0)
    # dot/conv get their true flop shares; the rest split the remainder by bytes
    shares["dot"] = sig.dot_flops / total_flops
    shares["conv"] = sig.conv_flops / total_flops
    rest_classes = [c for c in
                    ("sort", "reduce", "data_movement", "logic", "elementwise")
                    if sig.op_mix.get(c, 0.0) > 0]
    rest_bytes = sum(sig.op_mix.get(c, 0.0) for c in rest_classes)
    rest_share = max(1.0 - shares["dot"] - shares["conv"], 0.0)
    for c in rest_classes:
        shares[c] = rest_share * sig.op_mix[c] / max(rest_bytes, 1.0)
    return {k: v for k, v in shares.items() if v > 0.005}


def collective_shares(sig: Signature) -> Dict[str, float]:
    """Per-kind collective-byte share of total traffic (multi-device
    targets only; empty for every single-device profile)."""
    total = max(sig.bytes, 1.0)
    shares = {kind: b / total for kind, b in sig.collective_bytes.items()
              if b > 0.0}
    return {k: v for k, v in shares.items() if v > 0.005}


def decompose(sig: Signature,
              hints: Optional[Sequence[MotifHint]] = None,
              base_p: Optional[PVector] = None,
              name: str = "proxy",
              telemetry=None) -> ProxyBenchmark:
    """Build the initial (untuned) proxy benchmark for a target signature.

    With hints: motif set/variants fixed by the hints, weights seeded from
    the matching op-class shares (hint.weight overrides).  Without hints:
    one node per significant op class.  The work runs in a ``decompose``
    span on ``telemetry`` (the process default when ``None``)."""
    if telemetry is None:
        # core modules import nothing of repro_torch.runtime at module level
        from repro_torch.runtime.telemetry import get_default

        telemetry = get_default()
    base_p = base_p or PVector()
    with telemetry.span("decompose", name=name, hinted=bool(hints)) as sp:
        pb = _decompose(sig, hints, base_p, name)
        sp.set(nodes=len(pb.nodes))
        return pb


def _decompose(sig: Signature, hints: Optional[Sequence[MotifHint]],
               base_p: PVector, name: str) -> ProxyBenchmark:
    shares = hlo_shares(sig)
    coll = collective_shares(sig)

    rows: List[Tuple[str, str, float, Dict[str, object]]] = []
    if hints:
        # share per motif name (sum classes mapping to one motif)
        share_per_motif: Dict[str, float] = {}
        for cls, s in shares.items():
            m, _ = OPCLASS_TO_MOTIF[cls]
            share_per_motif[m] = share_per_motif.get(m, 0.0) + s
        for kind, s in coll.items():
            m, _ = COLLECTIVE_TO_MOTIF[kind]
            share_per_motif[m] = share_per_motif.get(m, 0.0) + s
        for h in hints:
            w = h.weight if h.weight is not None else max(
                share_per_motif.get(h.motif, 0.0), 0.05)
            rows.append((h.motif, h.variant, w, h.overrides()))
    else:
        for cls, s in sorted(shares.items(), key=lambda kv: -kv[1]):
            motif, variant = OPCLASS_TO_MOTIF[cls]
            rows.append((motif, variant, s, {}))
        for kind, s in sorted(coll.items(), key=lambda kv: -kv[1]):
            motif, variant = COLLECTIVE_TO_MOTIF[kind]
            for i, (m, v, w, ov) in enumerate(rows):
                if m == motif:
                    rows[i] = (m, v, w + s, ov)
                    break
            else:
                rows.append((motif, variant, s, {}))

    # normalise weights to mean 1 so `weight` stays in its tunable range,
    # and seed each node's data_size by its work share (paper: "scale down
    # the input data set ... to initialize dataSize")
    total_w = sum(r[2] for r in rows) or 1.0
    scale = len(rows) / total_w

    nodes: List[MotifNode] = []
    prev: Optional[str] = None
    for i, (motif, variant, w, overrides) in enumerate(rows):
        share = w / total_w
        sized = max(int(base_p.data_size * max(share * len(rows), 0.25)), 256)
        p = base_p.replace(weight=max(w * scale, 0.05), data_size=sized)
        p = p.replace(**overrides)
        nid = f"n{i}_{motif}"
        nodes.append(MotifNode(nid, motif, variant, p,
                               deps=(prev,) if prev else ()))
        prev = nid

    meta: Dict[str, object] = {
        "hlo_shares": shares,
        "target": {"flops": sig.flops, "bytes": sig.bytes},
    }
    if coll:
        meta["collective_shares"] = coll
    pb = ProxyBenchmark(name, tuple(nodes), meta=meta)
    pb.validate()
    return pb
