"""What each rank of a group runs to check the stress tier's distributed
runtime outside ``stress_matrix``: the GPipe ``pipeline_apply`` over
every rank as a stage, a state saved sharded and restored onto a
smaller mesh and onto one rank (the elastic restart), and a
``FaultTolerantRunner`` on a sharded state through one injected fault.

:func:`pipeline_and_restore` is one rank's part; start it on every rank
with ``repro_torch.distributed.launch.spawn``.  It takes its inputs as
host arrays and tensors (picklable) and returns plain Python values and
numpy arrays, so the caller holds them: ``tests/test_torch_pipeline_
parallel.py`` in two CPU ranks against the JAX reference, ``chip_smoke.py``
in four ranks sharing the card.
"""
from __future__ import annotations

import time
from typing import Dict, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.cluster import ClusterScenario, get_scenario, in_mesh
from repro_torch.device import resolve_device
from repro_torch.distributed.pipeline_parallel import (gpipe_reference,
                                                       pipeline_apply)
from repro_torch.distributed.sharding import local_slice, place, whole
from repro_torch.runtime import FaultTolerantRunner, RunnerConfig

#: the step the state is saved as
SAVE_STEP = 5


def stage_fn(w, h):
    """The reference test's stage block."""
    return torch.tanh(h @ w)


def tree_stage_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a, b)


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def pipeline_and_restore(device: str, w: np.ndarray, b: np.ndarray,
                         x: np.ndarray, state: Dict[str, torch.Tensor],
                         split: Dict[str, Sequence], save_on: str,
                         ckpt_root: str) -> dict:
    """One rank's part, on ``device``:

    * the pipeline over every rank as a stage, ``stage_fn`` on ``w`` and
      ``tree_stage_fn`` on ``{"w": w, "b": b}``, both also run as
      ``gpipe_reference`` on this rank alone (``pipe_err`` and
      ``pipe_tree_err`` the largest differences);
    * ``state`` (host tensors, the same on every rank) placed on the
      ``save_on`` scenario's mesh by ``split``, saved as ``SAVE_STEP``
      with ``blocking=False`` to this rank's directory, and restored onto
      dp2 by ``shardings`` (its two ranks only: a state saved on dp4
      comes back on a mesh two ranks smaller), as its DTensor prototypes
      are placed, and onto this rank alone; each check is exact, dtype
      included;
    * a ``FaultTolerantRunner`` on an (8,) state split over the save mesh,
      one fault injected at step 2.

    Also returns the seconds taken and, on CUDA, the device-memory peak."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    rank, n = dist.get_rank(), dist.get_world_size()
    mesh = ClusterScenario("pipe", n, (n,), ("pipe",)).mesh(dev.type)
    wt, bt, xt = (torch.from_numpy(a).to(dev) for a in (w, b, x))
    pipe = pipeline_apply(stage_fn, wt, xt, mesh, axis="pipe")
    tree = {"w": wt, "b": bt}
    pipe_tree = pipeline_apply(tree_stage_fn, tree, xt, mesh)
    out = {"rank": rank, "pipe": pipe.cpu().numpy(),
           "pipe_err": _err(pipe, gpipe_reference(stage_fn, wt, xt)),
           "pipe_tree": pipe_tree.cpu().numpy(),
           "pipe_tree_err": _err(pipe_tree,
                                 gpipe_reference(tree_stage_fn, tree, xt))}

    save_mesh = get_scenario(save_on).mesh(dev.type)
    dp2 = get_scenario("dp2").mesh(dev.type)  # a collective: every rank
    want = {k: v.to(dev) for k, v in state.items()}
    sharded = {k: place(v, save_mesh, split[k]) for k, v in want.items()}
    ckpt = CheckpointManager(f"{ckpt_root}/rank{rank}", keep=2)
    ckpt.save(SAVE_STEP, sharded, blocking=False)
    ckpt.wait()
    restore = {}
    if in_mesh(dp2):
        step, back = ckpt.restore(
            sharded, shardings={k: (dp2, split[k]) for k in want})
        restore.update(
            step=step,
            dp2_dtensors=all(isinstance(v, DTensor) and v.device_mesh is dp2
                             and v.placements == tuple(split[k])
                             for k, v in back.items()),
            dp2_local=all(_equal(back[k].to_local(),
                                 local_slice(want[k], dp2, split[k]))
                          for k in want),
            dp2_whole=all(_equal(whole(back[k]), want[k]) for k in want))
    step, like_protos = ckpt.restore(sharded)
    restore.update(
        step=step,
        like_protos=all(_equal(whole(like_protos[k]), want[k])
                        and like_protos[k].placements == tuple(split[k])
                        for k in want))
    step, one = ckpt.restore({k: torch.empty_like(v)
                              for k, v in want.items()})
    restore.update(step=step,
                   one_rank=all(not isinstance(one[k], DTensor)
                                and _equal(one[k], want[k]) for k in want))
    out["restore"] = restore

    def train_step(st, batch):
        new = {"w": st["w"] + batch}
        return new, {"loss": new["w"].sum()}

    faults = {"n": 0}

    def hook(step):
        if step == 2 and faults["n"] == 0:
            faults["n"] += 1
            raise RuntimeError("injected")

    split8 = (Shard(0),)
    runner = FaultTolerantRunner(
        train_step, {"w": place(torch.zeros(8, device=dev), save_mesh,
                                split8)},
        CheckpointManager(f"{ckpt_root}/runner{rank}", keep=3),
        RunnerConfig(total_steps=5, checkpoint_every=2, async_save=False),
        fault_hook=hook)
    res = runner.run(lambda step: place(torch.ones(8, device=dev),
                                        save_mesh, split8))
    out["runner"] = {**res, "w": whole(runner.state["w"]).cpu().numpy(),
                     "sharded": isinstance(runner.state["w"], DTensor),
                     "losses": [m["loss"] for m in runner.metrics_log]}
    out["seconds"] = time.perf_counter() - t0
    if dev.type == "cuda":
        out["max_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out
