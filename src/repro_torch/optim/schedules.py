"""Learning-rate schedules (port of ``repro/optim/schedules.py``):
multipliers in [0, 1] applied to the peak LR.

Each schedule takes the step as a tensor and returns an f32 tensor on
its device, so a train step reads nothing back to the host.
"""
from __future__ import annotations

import math

import torch

f32 = torch.float32


def warmup_cosine(warmup_steps: int, total_steps: int, floor: float = 0.1):
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(f32)
        warm = step / max(warmup_steps, 1)
        frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        frac = torch.clamp(frac, 0.0, 1.0)
        cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


def warmup_linear(warmup_steps: int, total_steps: int, floor: float = 0.0):
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(f32)
        warm = step / max(warmup_steps, 1)
        frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        lin = 1.0 - (1.0 - floor) * torch.clamp(frac, 0.0, 1.0)
        return torch.where(step < warmup_steps, warm, lin)
    return schedule
