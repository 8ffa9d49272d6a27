"""Train-step construction (port of ``repro/runtime/train_loop.py``):
loss -> grads (with microbatch accumulation) -> clip -> (optional
compression) -> AdamW -> new state.

``make_train_step`` returns a function ``(state, batch) -> (state,
metrics)`` on tensor trees.  It is functional, as the reference's is:
the state it is given stays as it was (a runner may retry a step from
it) and a new state is returned.  Gradients come from
``torch.autograd.grad`` over the param leaves; with ``cfg.grad_accum``
microbatches they are summed in f32 one microbatch after another, as
the reference's scan sums them.  Every metric is a 0-d tensor on the
params' device: nothing is read back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.distributed import spmd
from repro_torch.models.model_zoo import Model
from repro_torch.models.params import (ParamMeta, init_params, tree_leaves,
                                       tree_map)
from repro_torch.optim import (
    AdamWConfig,
    CompressionState,
    adamw_init_meta,
    adamw_update,
    ef_topk_compress_decompress,
)

f32 = torch.float32


@dataclass(frozen=True)
class TrainSettings:
    optimizer: AdamWConfig = AdamWConfig()
    compression: str = "none"          # none | ef_topk
    compression_ratio: float = 0.01
    remat: bool = True


TrainState = Dict[str, Any]  # {"params", "opt", ["comp"]}


def train_state_meta(model: Model, settings: TrainSettings) -> Dict[str, Any]:
    pm = model.param_meta()
    meta: Dict[str, Any] = {
        "params": pm,
        "opt": adamw_init_meta(pm, settings.optimizer),
    }
    if settings.compression == "ef_topk":
        meta["comp"] = tree_map(
            lambda m: ParamMeta(m.shape, f32, m.axes, "zeros", m.fan_in), pm)
    return meta


def init_train_state(generator: torch.Generator, model: Model,
                     settings: TrainSettings, *,
                     device: DeviceLike = None) -> TrainState:
    """Params drawn from ``generator`` on ``device`` (``None``: CUDA),
    zero moments and step, and zero compression residuals when the
    settings compress."""
    meta = train_state_meta(model, settings)
    return {k: init_params(m, generator=generator, device=device)
            for k, m in meta.items()}


def _split_microbatches(batch: Dict[str, torch.Tensor], accum: int):
    def split(x):
        return x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:]))
    return tree_map(split, batch)


def _value_and_grad(loss_fn, params, batch):
    """(loss, metrics, grads) of ``loss_fn(params, batch)`` over every
    param leaf; a leaf the loss does not reach gets a zero gradient, as
    under ``jax.grad``.  The loss and metrics come back detached."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(leaves, batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                     allow_unused=True,
                                     materialize_grads=True))
    return (loss.detach(), tree_map(torch.Tensor.detach, metrics),
            tree_map(lambda _: next(grads), leaves))


def _as_before(new, old):
    """``new`` placed as ``old`` was, where ``old`` is a DTensor: the
    state keeps its layout from step to step (an update mixing a
    replicated param with a ZeRO-sharded moment would leave it as the
    moment is)."""
    if spmd.is_dtensor(old) and tuple(new.placements) != tuple(old.placements):
        with torch.no_grad():
            return new.redistribute(old.device_mesh, old.placements)
    return new


def make_train_step(model: Model, settings: TrainSettings):
    cfg: ModelConfig = model.cfg
    accum = max(cfg.grad_accum, 1)

    def loss_fn(params, micro):
        return model.loss(params, micro, remat=settings.remat)

    def grads_of(params, batch):
        if accum == 1:
            return _value_and_grad(loss_fn, params, batch)

        micro = _split_microbatches(batch, accum)
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=f32,
                                              device=p.device), params)
        lsum = torch.zeros((), dtype=f32, device=tree_leaves(params)[0].device)
        for i in range(accum):
            loss, _, grads = _value_and_grad(
                loss_fn, params, tree_map(lambda t: t[i], micro))
            gsum = tree_map(lambda a, g: a + g.to(f32), gsum, grads)
            lsum = lsum + loss
        grads = tree_map(lambda g: g / accum, gsum)
        loss = lsum / accum
        zero = torch.zeros((), dtype=f32, device=loss.device)
        return loss, {"ce": loss, "aux": zero, "tokens": zero}, grads

    def train_step(state: TrainState, batch) -> Tuple[TrainState,
                                                      Dict[str, Any]]:
        params = state["params"]
        loss, metrics, grads = grads_of(params, batch)

        with torch.no_grad():
            comp_state = state.get("comp")
            stats: Dict[str, Any] = {}
            if settings.compression == "ef_topk" and comp_state is not None:
                grads, cs, cstats = ef_topk_compress_decompress(
                    grads, CompressionState(error=comp_state),
                    settings.compression_ratio)
                comp_state = cs.error
                stats.update(cstats)

            new_params, new_opt, ostats = adamw_update(
                params, grads, state["opt"], settings.optimizer)
        new_state: TrainState = {"params": new_params, "opt": new_opt}
        if comp_state is not None:
            new_state["comp"] = comp_state
        new_state = tree_map(_as_before, new_state,
                             {k: state[k] for k in new_state})
        out = {"loss": loss, **metrics, **ostats, **stats}
        return new_state, out

    return train_step
