"""Start a group of ranks on this host, each a process running one
function (SPMD: the same program on every rank).

The group rendezvous through a file in a fresh directory (``file://``),
so concurrent groups on one host never race for a port.  On the CPU the
backend is gloo; on CUDA it is gloo too (``cpu:gloo,cuda:gloo``), since
the ranks may share one card and NCCL refuses two ranks on one device.
Every rank of a CUDA group uses device 0 unless the host has a card a
rank; a CPU rank stands for one device and computes on one thread, so
work split across ranks runs side by side, as on devices.

:func:`spawn` waits for every rank up to a time limit, so a hung
collective fails instead of blocking its caller, and returns each rank's
result (pickled through the rendezvous directory).
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank() -> int:
    """This process's rank in the default group (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def gather_objects(obj: Any) -> List[Any]:
    """``obj`` from every rank of the default group, in rank order
    (``[obj]`` without a group)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def backend_for(device_type: str) -> str:
    return "cpu:gloo,cuda:gloo" if device_type == "cuda" else "gloo"


def init_rank(rank: int, world: int, init_file: str, device_type: str,
              timeout_s: float) -> None:
    """Join the group of ``world`` ranks that rendezvous at ``init_file``
    as ``rank``."""
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:  # a rank stands for one device: one thread, none shared
        torch.set_num_threads(1)
    dist.init_process_group(
        backend_for(device_type), init_method=f"file://{init_file}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))


def _entry(rank: int, fn: Callable, world: int, rdv: str, device_type: str,
           timeout_s: float, args: Sequence[Any]) -> None:
    init_rank(rank, world, os.path.join(rdv, "init"), device_type, timeout_s)
    try:
        out = fn(*args)
        with open(os.path.join(rdv, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args: Any, device_type: str = "cpu",
          timeout_s: float = 600.0, rdv_dir: Optional[str] = None
          ) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` new ranks (``fn`` must be picklable:
    a module-level function) and return their results in rank order.
    Raises ``TimeoutError`` and ends every rank when they have not all
    finished within ``timeout_s``; a rank's exception fails the call."""
    rdv = tempfile.mkdtemp(prefix="rdv", dir=rdv_dir)
    ctx = mp.start_processes(
        _entry, args=(fn, world, rdv, device_type, timeout_s, tuple(args)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{world} ranks did not finish within {timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(5)
            if p.is_alive():
                p.kill()
    out = []
    for r in range(world):
        with open(os.path.join(rdv, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
