"""GPipe-style pipeline parallelism over a "pipe" mesh axis (port of
``repro/distributed/pipeline_parallel.py``).

Stages hold contiguous layer groups; microbatches stream through a ring
shift between the ranks of a 1-D ``DeviceMesh``, one rank a stage.  The
schedule is the reference's fill-drain GPipe loop with
(num_microbatches + num_stages - 1) ticks; each tick every stage runs
its block on the microbatch it holds, then shifts its activation to the
next stage (the last stage's to the first, unused).  The last stage's
outputs are then broadcast, so every caller gets the result, as the
reference's global array gives it.

The shift is one ``batch_isend_irecv`` a tick (a send to the next stage
and a receive from the previous, never a blocking send on every rank),
on host copies of the activations: gloo cannot send a CUDA tensor.
On one stage (``mesh=None``) the shift is the identity and there is no
group.  This module is topology code only: it composes with any
per-stage block function.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves, tree_map


def _stage_of(stage_params: Any, s: int) -> Any:
    return tree_map(lambda t: t[s], stage_params)


def _ring_shift(y: torch.Tensor, stage: int, ranks, group) -> torch.Tensor:
    """``y`` of the previous stage, on this stage (the ring's
    ``ppermute``), through host memory: gloo's send and receive read a
    CUDA tensor's device address as a host one (torch 2.11 aborts,
    "writev: Bad address"), so a CUDA activation travels as a host copy."""
    n = len(ranks)
    wire = y.cpu().contiguous()
    got = torch.empty_like(wire)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, wire, ranks[(stage + 1) % n], group),
        dist.P2POp(dist.irecv, got, ranks[(stage - 1) % n], group)])
    for w in works:
        w.wait()
    return got.to(y.device)


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,       # (num_stages, ...) stacked per-stage params
    x: torch.Tensor,         # (num_microbatches, mb, ...) inputs
    mesh,
    axis: str = "pipe",
) -> torch.Tensor:
    """Run ``x`` through the pipeline stages living on ``mesh``'s ``axis``
    (``None``: one stage, on this rank).  Every rank of the mesh calls
    this with the whole ``stage_params`` and ``x``; rank ``s`` of the axis
    runs ``stage_params[s]``.

    Returns outputs in microbatch order, shape like ``x``, on every
    rank."""
    if mesh is None:
        num_stages, stage, ranks, group = 1, 0, (None,), None
    else:
        if tuple(mesh.mesh_dim_names or ()) != (axis,):
            raise ValueError(f"pipeline_apply needs a 1-D mesh over "
                             f"{axis!r}, got {mesh.mesh_dim_names}")
        num_stages = mesh.size(0)
        stage = mesh.get_local_rank(axis)
        ranks = tuple(int(r) for r in mesh.mesh.flatten().tolist())
        group = mesh.get_group(axis)
    num_mb = x.shape[0]
    params = _stage_of(stage_params, stage)
    last = num_stages - 1

    buf = torch.zeros_like(x[0])  # the activation this stage holds
    outs = torch.zeros_like(x)
    for t in range(num_mb + num_stages - 1):
        # stage 0 injects microbatch t (the last one again in the drain)
        fed = x[min(t, num_mb - 1)] if stage == 0 else buf
        y = stage_fn(params, fed)
        # the last stage emits completed microbatch t - (num_stages - 1)
        if stage == last and t >= last:
            outs[t - last] = y
        buf = y if num_stages == 1 else _ring_shift(y, stage, ranks, group)
    if num_stages > 1:  # only the last stage's copy holds real outputs
        dist.broadcast(outs, src=ranks[last], group=group)
    return outs


def gpipe_reference(stage_fn, stage_params, x):
    """Sequential oracle: run every stage over every microbatch in order."""
    num_stages = tree_leaves(stage_params)[0].shape[0]

    def one_mb(mb):
        y = mb
        for s in range(num_stages):
            y = stage_fn(_stage_of(stage_params, s), y)
        return y

    return torch.stack([one_mb(mb) for mb in x])
