"""Set motif — operations on collections of distinct data + relational
algebra primitives (port of ``repro/core/motifs/set_ops.py``).

Variants:
* ``union`` / ``intersect``  (distinct-collection operations, sort-merge)
* ``groupby``                (relational aggregation as a one-hot product)
* ``join``                   (sort-merge equi-join via searchsorted ranks)

Fixed-size outputs everywhere, as in the reference: set results carry a
validity mask instead of a dynamic length.  Sorts, searches, compares and
``%`` of the uint32 keys run on their int64 widening
(``repro_torch.uint32``); counts are int32 as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.motifs.base import Motif, PVector, register
from repro_torch.data.generators import gen_keys, gen_vectors, make_generator
from repro_torch.device import resolve_device
from repro_torch.uint32 import narrow, widen


def sorted_unique_mask(x: torch.Tensor):
    """Sorted int64-widened values + mask of first occurrences (a
    fixed-size 'distinct')."""
    s = torch.sort(widen(x)).values
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                       s[1:] != s[:-1]])
    return s, first


def _count(mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(mask, dtype=torch.int32)


@register
class SetMotif(Motif):
    name = "set"
    variants = ("union", "intersect", "groupby", "join")
    default_variant = "groupby"
    tunable = ("data_size", "chunk_size", "num_tasks", "weight", "channels")
    data_kind = "keys"

    def make_inputs(self, p: PVector, seed: int,
                    device: Optional[torch.device] = None) -> Dict[str, Any]:
        gen = make_generator(seed, resolve_device(device))
        n = int(max(p.data_size, 64))
        a = gen_keys(gen, n, p.spec())
        b = gen_keys(gen, n, p.spec())
        # bounded-cardinality group labels + values for groupby/join
        groups = (widen(a) % max(p.channels, 2)).to(torch.int32)
        vals = gen_vectors(gen, n, 1, p.spec())[:, 0]
        return {"a": a, "b": b, "groups": groups, "vals": vals}

    def apply(self, p: PVector, inputs: Dict[str, Any], variant: str = "") -> Any:
        v = self.resolve_variant(variant)
        a, b = inputs["a"], inputs["b"]

        if v == "union":
            s, mask = sorted_unique_mask(torch.cat([widen(a), widen(b)]))
            return {"sorted": narrow(s, a.dtype), "mask": mask,
                    "cardinality": _count(mask)}

        if v == "intersect":
            sa, ma = sorted_unique_mask(a)
            # membership of each distinct a-key in b (sorted binary search)
            sb = torch.sort(widen(b)).values
            pos = torch.clamp(torch.searchsorted(sb, sa), 0, sb.shape[0] - 1)
            hit = (sb[pos] == sa) & ma
            return {"keys": narrow(sa, a.dtype), "mask": hit,
                    "cardinality": _count(hit)}

        if v == "groupby":
            g, vals = inputs["groups"], inputs["vals"]
            k = max(p.channels, 2)
            # the one-hot is a compare, as jax.nn.one_hot: (n, k)
            onehot = (g[:, None] == torch.arange(k, device=g.device)).to(
                vals.dtype)
            sums = onehot.T @ vals
            counts = torch.sum(onehot, dim=0)
            return {"sums": sums, "counts": counts,
                    "means": sums / torch.clamp_min(counts, 1.0)}

        # join: for each key of a, find matches in sorted b (equi-join probe)
        sb = torch.sort(widen(b)).values
        wa = widen(a)
        lo = torch.searchsorted(sb, wa, side="left")
        hi = torch.searchsorted(sb, wa, side="right")
        matches = (hi - lo).to(torch.int32)
        return {"match_counts": matches, "total": _count(matches),
                "hit_frac": torch.mean((matches > 0).to(torch.float32))}
