"""The comparison that decides ``correct``: every node's outputs of the
program's last run against the plain reference's.

Two numbers, each held to a limit of the cell's own
(``limits/<cell>.json``):

* ``rel_err``: the worst output's relative error.  A float output's is
  its largest absolute difference from the reference over the
  reference's largest magnitude in it.  An output of indices that an
  argmin or argmax picked is judged by its scores: how far the score of
  the program's pick lies from the best score, both read from the
  reference's scores, over their largest magnitude; so a near tie that
  rounding breaks the other way costs only its width, in the same units
  as the scores' own error.
* ``exact_mismatch``: integer outputs (sorted keys, payloads, counts)
  compared element by element, plus every element of an output that is
  missing, extra, or of another shape or dtype.  Its limit is 0.

A number that is not finite fails.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

NUMBERS = ("rel_err", "exact_mismatch")


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    g, r = got.to(torch.float64), ref.to(torch.float64)
    err = float(torch.max(torch.abs(g - r))) if r.numel() else 0.0
    if not math.isfinite(err):
        return math.inf
    scale = float(torch.max(torch.abs(r))) if r.numel() else 0.0
    return err / scale if scale > 0 else (0.0 if err == 0 else math.inf)


def choice_gap(got: torch.Tensor, scores: torch.Tensor, sense: str) -> float:
    idx = got.to(torch.int64)
    if idx.numel() == 0:
        return 0.0
    if int(idx.min()) < 0 or int(idx.max()) >= scores.shape[-1]:
        return math.inf
    s = scores.to(torch.float64)
    picked = torch.gather(s, -1, idx[..., None])[..., 0]
    best = s.amin(-1) if sense == "min" else s.amax(-1)
    scale = float(torch.max(torch.abs(s)))
    gap = float(torch.max(torch.abs(picked - best)))
    return gap / scale if scale > 0 else (0.0 if gap == 0 else math.inf)


def compare(got: Mapping[str, Mapping[str, torch.Tensor]],
            ref: Mapping[str, Mapping[str, torch.Tensor]],
            choices: Mapping[str, Mapping[str, Tuple[torch.Tensor, str]]]
            ) -> Dict[str, float]:
    """The numbers of one run, all on the same device."""
    out: Dict[str, float] = {"rel_err": 0.0, "exact_mismatch": 0}
    for node, leaves in ref.items():
        mine = got.get(node, {})
        for key in set(mine) - set(leaves):
            out["exact_mismatch"] += max(mine[key].numel(), 1)
        for key, r in leaves.items():
            g = mine.get(key)
            if g is None or g.shape != r.shape or g.dtype != r.dtype:
                out["exact_mismatch"] += max(r.numel(), 1)
            elif key in choices.get(node, {}):
                out["rel_err"] = max(out["rel_err"],
                                     choice_gap(g, *choices[node][key]))
            elif r.dtype.is_floating_point:
                out["rel_err"] = max(out["rel_err"], rel_err(g, r))
            else:
                out["exact_mismatch"] += int(torch.sum(_bits(g) != _bits(r)))
    for node in set(got) - set(ref):
        out["exact_mismatch"] += sum(max(v.numel(), 1)
                                     for v in got[node].values())
    return out


def judge(numbers: Mapping[str, float],
          limits: Mapping[str, float]) -> bool:
    """Every number at or under its limit; a number with no limit is a
    fault of the cell's files."""
    missing = set(numbers) - set(limits)
    if missing:
        raise KeyError(f"no limit for {sorted(missing)}")
    return all(numbers[k] <= limits[k] for k in numbers)
