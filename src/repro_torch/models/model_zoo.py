"""Public model API of the port: build_model(config) -> Model (port of
``repro/models/model_zoo.py``'s serving half).

A Model exposes, as the reference's does:

* ``param_meta()`` / ``cache_meta(batch, seq)`` — ParamMeta trees,
* ``abstract()`` — meta-device tensors (no memory),
* ``init(generator, device=)`` — materialised params,
* ``forward(params, batch)`` — teacher-forced logits,
* ``prefill(params, batch)`` — (last-token logits, caches),
* ``decode(params, caches, batch)`` — (logits, caches); batch carries
  ``tokens`` (B, 1) and ``index`` (a 0-d integer tensor on the model's
  device, the position being written).  Decode writes the new K/V into
  the cache tensors it is given and returns them (the reference donates
  them); it reads nothing back to the host, so a step can be captured as
  a CUDA graph.

:func:`build_model` builds the dense and VLM decoders.  A config that
needs a mixer or block this port does not have yet (MoE, MLA, SSM, RG-LRU,
encoder-decoder) raises ``NotImplementedError`` naming the ROADMAP item;
nothing falls back to another model.  ``cross_entropy``, ``loss`` and the
encoder-decoder model come with training.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.data.generators import torch_dtype
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import trunk
from repro_torch.models.params import abstract_params, init_params, tree_map

f32 = torch.float32


def unported(cfg: ModelConfig) -> Optional[str]:
    """What of ``cfg`` the port cannot build yet (``None``: all of it)."""
    if cfg.is_encoder_decoder:
        return "the encoder-decoder model (models/whisper.py, cross attention)"
    if cfg.moe is not None:
        return "the MoE layer (layers.py moe_apply, sort dispatch)"
    if cfg.mla is not None:
        return "multi-head latent attention (layers.py mla_apply)"
    if cfg.family == "ssm" or cfg.ssm is not None:
        return "the Mamba-2 SSD block (models/mamba2.py)"
    if cfg.rglru is not None or "recurrent" in cfg.layer_pattern:
        return "the RG-LRU block (models/rglru.py)"
    return None


class Model:
    """Decoder-only LM (the dense and VLM families of the zoo)."""

    def __init__(self, cfg: ModelConfig):
        missing = unported(cfg)
        if missing is not None:
            raise NotImplementedError(
                f"{cfg.name}: {missing} is not ported to repro_torch yet "
                f"(ROADMAP queue 1 item 5a')")
        self.cfg = cfg

    # -- metadata -----------------------------------------------------------
    def param_meta(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "embed": L.embed_meta(cfg),
            "trunk": trunk.trunk_meta(cfg),
            "final_norm": L.norm_meta(cfg),
        }

    def cache_meta(self, batch: int, seq: int) -> Dict[str, Any]:
        return trunk.trunk_cache_meta(self.cfg, batch, seq)

    def abstract(self):
        return abstract_params(self.param_meta())

    def init(self, generator: torch.Generator, *, device: DeviceLike = None):
        """Params drawn from ``generator`` on ``device`` (``None``: CUDA)."""
        return init_params(self.param_meta(), generator=generator,
                           device=device)

    # -- embedding + frontend stubs ------------------------------------------
    def _embed_inputs(self, params, batch: Dict[str, torch.Tensor],
                      index: Optional[torch.Tensor] = None):
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        start = 0 if index is None else index
        pos_ids = torch.arange(S, device=tokens.device)[None] + start
        x = L.embed_apply(params["embed"], cfg, tokens, positions=pos_ids)
        if cfg.frontend == "vision_patches" and "patch_embeds" in batch:
            pe = batch["patch_embeds"].to(x.dtype)
            x = torch.cat([pe, x], dim=1)
            pos_ids = torch.arange(x.shape[1], device=tokens.device)[None] + start
        return x, pos_ids

    # -- forward ----------------------------------------------------------------
    def forward(self, params, batch):
        """(logits (B, S, V) f32 over the text positions, aux loss)."""
        cfg = self.cfg
        x, positions = self._embed_inputs(params, batch)
        x, _, aux = trunk.trunk_apply(params["trunk"], cfg, x,
                                      positions=positions)
        x = L.norm_apply(params["final_norm"], cfg, x)
        if cfg.frontend == "vision_patches" and "patch_embeds" in batch:
            x = x[:, batch["patch_embeds"].shape[1]:]  # text positions only
        logits = L.unembed_apply(params["embed"], cfg, x)
        return logits, aux

    # -- serving ---------------------------------------------------------------
    def prefill(self, params, batch):
        """(logits (B, 1, V) of the last position, caches of every one)."""
        cfg = self.cfg
        x, positions = self._embed_inputs(params, batch)
        x, caches, _ = trunk.trunk_apply(params["trunk"], cfg, x,
                                         positions=positions, want_cache=True)
        x = L.norm_apply(params["final_norm"], cfg, x[:, -1:])
        logits = L.unembed_apply(params["embed"], cfg, x)
        return logits, caches

    def decode(self, params, caches, batch):
        """(logits (B, 1, V), caches) for ``batch["tokens"]`` (B, 1) at
        position ``batch["index"]``; ``caches`` are written in place."""
        cfg = self.cfg
        index = batch["index"]
        x, _ = self._embed_inputs(params, batch, index=index)
        x, caches, _ = trunk.trunk_apply(params["trunk"], cfg, x,
                                         positions=index, caches=caches,
                                         index=index)
        x = L.norm_apply(params["final_norm"], cfg, x)
        logits = L.unembed_apply(params["embed"], cfg, x)
        return logits, caches


def build_model(cfg: ModelConfig) -> Model:
    """The port's model for ``cfg``; raises ``NotImplementedError`` for a
    config it cannot build yet (:func:`unported`)."""
    return Model(cfg)


# ---------------------------------------------------------------------------
# Input specs (meta-device stand-ins; also shapes for drivers)
# ---------------------------------------------------------------------------


def _spec(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, cell: ShapeCell,
                model: Optional[Model] = None) -> Dict[str, Any]:
    """Meta-device tensors for every model input of a shape cell."""
    model = model or build_model(cfg)
    B, S = cell.global_batch, cell.seq_len
    i32 = torch.int32
    bf = torch_dtype(cfg.dtype)

    if cell.kind in ("train", "prefill"):
        specs: Dict[str, Any] = {}
        if cfg.frontend == "vision_patches":
            vt = cfg.frontend_tokens
            specs["patch_embeds"] = _spec((B, vt, cfg.d_model), bf)
            specs["tokens"] = _spec((B, S - vt), i32)
        else:
            specs["tokens"] = _spec((B, S), i32)
        if cell.kind == "train":
            specs["labels"] = _spec(specs["tokens"].shape, i32)
        return specs

    if cell.kind == "decode":
        return {
            "caches": abstract_params(model.cache_meta(B, S)),
            "tokens": _spec((B, 1), i32),
            "index": _spec((), i32),
        }
    raise ValueError(cell.kind)


def make_inputs(cfg: ModelConfig, cell: ShapeCell, generator: torch.Generator,
                model: Optional[Model] = None, *,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random inputs matching :func:`input_specs` on ``device`` (``None``:
    CUDA), drawn from ``generator`` (on that device): tokens uniform over
    the vocabulary, floats normal at 0.02, the decode index
    ``seq_len // 2``."""
    dev = resolve_device(device)
    specs = input_specs(cfg, cell, model)

    def fill(s: torch.Tensor) -> torch.Tensor:
        if s.dtype == torch.int32:
            if s.dim() == 0:
                return torch.full((), cell.seq_len // 2, dtype=torch.int32,
                                  device=dev)
            return torch.randint(0, max(cfg.vocab_size, 2), s.shape,
                                 generator=generator, device=dev,
                                 dtype=torch.int32)
        x = torch.empty(s.shape, dtype=f32, device=dev)
        return x.normal_(0.0, 0.02, generator=generator).to(s.dtype)

    return tree_map(fill, specs)
