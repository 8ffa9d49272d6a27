"""AdamW on ParamMeta trees (port of ``repro/optim/adamw.py``; no
``torch.optim``).

The optimiser state is the reference's tree ``{"m", "v", "step"}``:
moment trees that mirror the params (same keys and logical axes) and a
0-d int32 step, so ``CheckpointManager`` writes it in the reference's
on-disk form.  The update is functional: it returns new params and
moments and leaves its inputs as they were, with exactly the
reference's arithmetic in f32 (bias corrections ``1 - b**step``, then
``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)``), each result cast
back to its leaf's dtype.  Nothing is read back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.data.generators import torch_dtype
from repro_torch.models.params import ParamMeta, tree_leaves, tree_map

f32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4                    # peak LR if a schedule is used
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        """The LR at ``step`` (a tensor): an f32 0-d tensor on its
        device."""
        if self.schedule is None:
            return torch.full((), self.lr, dtype=f32, device=step.device)
        return self.schedule(step) * self.lr


def adamw_init_meta(param_meta, ocfg: AdamWConfig) -> Dict[str, Any]:
    md = torch_dtype(ocfg.moment_dtype)

    def mom(m: ParamMeta) -> ParamMeta:
        return ParamMeta(m.shape, md, m.axes, "zeros", m.fan_in)

    return {
        "m": tree_map(mom, param_meta),
        "v": tree_map(mom, param_meta),
        "step": ParamMeta((), torch.int32, (), "zeros", 0),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, leaf by leaf
    in the tree's order, as the reference sums them."""
    return torch.sqrt(sum(torch.sum(torch.square(t.to(f32)))
                          for t in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float) -> Tuple[Any, torch.Tensor]:
    gn = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(f32) * scale).to(g.dtype), tree), gn


def adamw_update(params, grads, opt_state, ocfg: AdamWConfig):
    """One AdamW step.  Returns (new_params, new_opt_state, stats)."""
    step = opt_state["step"] + 1
    lr = ocfg.lr_at(step)
    if ocfg.grad_clip:
        grads, gnorm = clip_by_global_norm(grads, ocfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    b1, b2 = ocfg.b1, ocfg.b2
    bc1 = 1.0 - torch.pow(b1, step.to(f32))
    bc2 = 1.0 - torch.pow(b2, step.to(f32))

    def upd(p, g, m, v):
        g32 = g.to(f32)
        m32 = m.to(f32) * b1 + g32 * (1.0 - b1)
        v32 = v.to(f32) * b2 + torch.square(g32) * (1.0 - b2)
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + ocfg.eps)
        p32 = p.to(f32)
        p32 = p32 - lr * (delta + ocfg.weight_decay * p32)
        return p32.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    new_params = tree_map(lambda t: t[0], out)
    new_m = tree_map(lambda t: t[1], out)
    new_v = tree_map(lambda t: t[2], out)
    return new_params, {"m": new_m, "v": new_v, "step": step}, {
        "grad_norm": gnorm, "lr": lr}
