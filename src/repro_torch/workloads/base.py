"""Real-world workloads as eager PyTorch programs (port of
``repro/workloads/base.py``).

Each workload packages input construction at a configurable scale, a
``step`` function (the unit the paper profiles), and its Table III motif
hints (the bottom-up-analysis result the decomposing stage consumes).
``scale`` shrinks the data while keeping its type, pattern and
distribution.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.decompose import MotifHint
from repro_torch.data.generators import make_generator
from repro_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class Workload:
    """One of the paper's real workloads plus its cluster annotations.

    ``input_axes`` names the logical axis of each positional ``step``
    argument's *leading* dim — ``"batch"`` for data that splits across a
    cluster scenario's data axis (records, samples, edges), ``None`` for
    replicated state (parameters, centroids).  The sharding rule table
    (:mod:`repro_torch.distributed.sharding`) maps logical names onto the
    scenario's mesh; without a mesh they are inert.  Shorter tuples are
    padded with ``None``."""

    name: str
    make_inputs: Callable[[torch.Generator, float], Tuple[Any, ...]]
    step: Callable[..., Any]
    hints: Tuple[MotifHint, ...]
    input_axes: Tuple[Optional[str], ...] = ()

    def inputs(self, seed: int = 0, scale: float = 1.0,
               device: DeviceLike = None) -> Tuple[Any, ...]:
        """The step's arguments, made on ``device`` from ``seed``."""
        gen = make_generator(seed, resolve_device(device))
        return self.make_inputs(gen, scale)


WORKLOADS: Dict[str, Workload] = {}


def register_workload(w: Workload) -> Workload:
    WORKLOADS[w.name] = w
    return w
