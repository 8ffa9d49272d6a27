"""Fault tolerance + straggler mitigation for the training runtime (port
of ``repro/runtime/fault_tolerance.py``).

* **StepMonitor** — EMA step-time model; a step slower than
  ``straggler_factor x`` EMA flags a straggler (surfaced in metrics and
  logs, unit-tested with injected delays).  A hard ``stall_timeout``
  marks the worker dead.
* **NaN/loss-spike guard** — non-finite loss (a flipped bit, a bad batch,
  a desynced collective) triggers restore-from-last-good + batch skip
  instead of poisoning the run.
* **FaultTolerantRunner** — drives (train_step, checkpoints):
  resume-from-latest on construction, periodic async saves, bounded
  retry-with-restore on failure.  Failure injection hooks make the
  recovery paths testable on one host.

A metric is read with ``.item()``: on CUDA that waits for the device, as
the reference's ``device_get`` does, so a step's wall covers its device
work.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed.sharding import whole


@dataclass
class StepMonitor:
    ema_alpha: float = 0.1
    straggler_factor: float = 2.5
    stall_timeout_s: float = 300.0
    ema_s: Optional[float] = None
    stragglers: List[int] = field(default_factory=list)
    last_progress: float = field(default_factory=time.time)

    def observe(self, step: int, dt: float) -> Dict[str, Any]:
        self.last_progress = time.time()
        is_straggler = (self.ema_s is not None
                        and dt > self.straggler_factor * self.ema_s)
        if is_straggler:
            self.stragglers.append(step)
        else:
            # stragglers do not contaminate the EMA baseline
            self.ema_s = (dt if self.ema_s is None
                          else (1 - self.ema_alpha) * self.ema_s
                          + self.ema_alpha * dt)
        return {"step_time_s": dt, "step_time_ema_s": self.ema_s,
                "straggler": is_straggler}

    def stalled(self) -> bool:
        return time.time() - self.last_progress > self.stall_timeout_s


def _scalar(v: Any) -> Optional[float]:
    """A 0-d metric as a float (a DTensor made whole first), else
    ``None``."""
    if isinstance(v, torch.Tensor):
        return float(whole(v).item()) if v.ndim == 0 else None
    return float(v) if np.ndim(v) == 0 else None


def _loss_bad(metrics: Dict[str, Any]) -> bool:
    loss = metrics.get("loss")
    if loss is None:
        return False
    return not math.isfinite(_scalar(loss))


@dataclass
class RunnerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    keep_checkpoints: int = 3
    max_retries_per_step: int = 2
    async_save: bool = True


class FaultTolerantRunner:
    """Checkpoint/restart training loop."""

    def __init__(self, train_step: Callable[[Any, Any], Tuple[Any, Dict]],
                 state: Any, ckpt: CheckpointManager,
                 config: RunnerConfig = RunnerConfig(),
                 monitor: Optional[StepMonitor] = None,
                 fault_hook: Optional[Callable[[int], None]] = None):
        self.train_step = train_step
        self.ckpt = ckpt
        self.config = config
        self.monitor = monitor or StepMonitor()
        self.fault_hook = fault_hook          # tests inject failures here
        self.metrics_log: List[Dict[str, Any]] = []
        self.recoveries = 0

        latest = ckpt.latest_step()
        if latest is not None:
            self.start_step, self.state = ckpt.restore(state)
            self.start_step += 1
        else:
            self.start_step, self.state = 0, state
            ckpt.save(0, state, blocking=True)  # step-0 restore anchor

    def _restore_last_good(self, like: Any) -> int:
        step, self.state = self.ckpt.restore(like)
        self.recoveries += 1
        return step

    def run(self, batches: Callable[[int], Any]) -> Dict[str, Any]:
        cfg = self.config
        step = self.start_step
        while step < cfg.total_steps:
            batch = batches(step)
            retries = 0
            while True:
                # re-stamped per ATTEMPT: the EMA baseline must observe
                # only the successful attempt's wall, not the failed
                # attempt + checkpoint restore that preceded it — a
                # retried step would otherwise ingest its wall twice
                # over and both poison the straggler baseline and flag
                # the recovered step itself as a straggler
                t0 = time.time()
                try:
                    if self.fault_hook is not None:
                        self.fault_hook(step)
                    new_state, metrics = self.train_step(self.state, batch)
                    if _loss_bad(metrics):
                        raise FloatingPointError(
                            f"non-finite loss at step {step}")
                    self.state = new_state
                    break
                except Exception:  # noqa: BLE001
                    retries += 1
                    if retries > cfg.max_retries_per_step:
                        raise
                    # restore last good checkpoint and retry this batch
                    self._restore_last_good(self.state)
            mstats = self.monitor.observe(step, time.time() - t0)
            scalars = {k: _scalar(v) for k, v in metrics.items()}
            self.metrics_log.append(
                {"step": step, "retries": retries, **mstats,
                 **{k: v for k, v in scalars.items() if v is not None}})
            if cfg.checkpoint_every and (step + 1) % cfg.checkpoint_every == 0:
                self.ckpt.save(step, self.state,
                               blocking=not cfg.async_save)
            step += 1
        self.ckpt.wait()
        self.ckpt.save(cfg.total_steps - 1, self.state, blocking=True)
        return {"final_step": step, "recoveries": self.recoveries,
                "stragglers": list(self.monitor.stragglers)}
