"""Public model API of the port: build_model(config) -> Model (port of
``repro/models/model_zoo.py``).

A Model (and the encoder-decoder :class:`EncDecModel`) exposes, as the
reference's does:

* ``param_meta()`` / ``cache_meta(batch, seq)`` — ParamMeta trees,
* ``abstract(shardings=)`` — meta-device tensors (no memory; DTensors
  of their local shape where sharded),
* ``init(generator, device=)`` — materialised params,
* ``forward(params, batch)`` — teacher-forced logits and the MoE layers'
  summed auxiliary loss (0 without MoE),
* ``loss(params, batch)`` — the masked token cross-entropy plus that
  auxiliary loss, and metrics (``ce``, ``aux``, ``tokens``),
* ``prefill(params, batch)`` — (last-token logits, caches),
* ``decode(params, caches, batch)`` — (logits, caches); batch carries
  ``tokens`` (B, 1) and ``index`` (a 0-d integer tensor on the model's
  device, the position being written).  Decode writes the new K/V (or
  recurrent state) into the cache tensors it is given and returns them
  (the reference donates them); it reads nothing back to the host, so a
  step can be captured as a CUDA graph.

:func:`build_model` builds all ten configs of the zoo: the dense, VLM and
MoE decoders (GQA or multi-head latent attention; dense or MoE
feed-forward layers), Mamba-2 and the RG-LRU hybrid through the trunk,
and Whisper as an :class:`EncDecModel` (its batches carry ``frames``, the
stubbed frontend's embeddings).  ``forward``, ``loss`` and ``prefill``
take ``remat``: each layer is recomputed in the backward pass
(``trunk.trunk_apply``, ``whisper.encode``/``decode_stack``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.data.generators import torch_dtype
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import shard, spmd
from repro_torch.models import layers as L
from repro_torch.models import trunk, whisper
from repro_torch.models.params import abstract_params, init_params, tree_map

f32 = torch.float32


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  impl: str = "gather") -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked token cross-entropy in f32: (mean over the labels >= 0,
    their count clamped at 1).  Labels < 0 are ignored.  ``impl="onehot"``
    takes the gold logit by a masked reduction over the vocabulary
    instead of a gather, as the reference's does (its vocab-sharded
    form); DTensor logits always take it."""
    logits = logits.to(f32)
    mask = (labels >= 0).to(f32)
    safe = torch.clamp(labels, min=0).to(torch.int64)
    if spmd.is_dtensor(logits):
        # max, exp-sum and log as separate reductions, each a partial
        # result over a vocab-sharded dim (DTensor's logsumexp gathers
        # the whole vocabulary first); the max is a constant of the
        # gradient, as in the fused op
        top = logits.amax(dim=-1, keepdim=True).detach()
        # each token's sum, and its gradient, split as the tokens are
        total = shard(torch.exp(logits - top).sum(dim=-1), "batch", "seq")
        logz = torch.log(total) + top[..., 0]
    else:
        logz = torch.logsumexp(logits, dim=-1)
    if impl == "onehot" or spmd.is_dtensor(logits):
        # on DTensors too: a gather's backward scatters into a zero
        # tensor DTensor makes whole, and its select loses the masked
        # partial sum of a vocab-sharded gather; the masked sum is exact
        # (the other terms are zeros)
        v_iota = torch.arange(logits.shape[-1], device=logits.device)
        if spmd.is_dtensor(logits):  # split as the logits' vocab is
            v_iota = shard(v_iota, "vocab")
        gold = torch.where(v_iota == safe[..., None], logits,
                           torch.zeros((), dtype=f32, device=logits.device)
                           ).sum(dim=-1)
        if spmd.is_dtensor(gold):
            gold = shard(gold, "batch", "seq")
    else:
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    return nll.sum() / denom, denom


class Model:
    """Decoder-only LM (covers dense / moe / ssm / hybrid / vlm)."""

    def __init__(self, cfg: ModelConfig):
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

    def abstract(self, shardings=None):
        """Meta-device tensors of every param (:func:`abstract_params`):
        no storage at any size; DTensors where ``shardings`` shard."""
        return abstract_params(self.param_meta(), shardings)

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

    # -- forward / loss -------------------------------------------------------
    def forward(self, params, batch, *, remat: bool = False):
        """(logits (B, S, V) f32 over the text positions, the MoE layers'
        summed aux loss)."""
        cfg = self.cfg
        x, positions = self._embed_inputs(params, batch)
        x, _, aux = trunk.trunk_apply(params["trunk"], cfg, x,
                                      positions=positions, remat=remat)
        x = L.norm_apply(params["final_norm"], cfg, x)
        if cfg.frontend == "vision_patches" and "patch_embeds" in batch:
            x = x[:, batch["patch_embeds"].shape[1]:]  # text positions only
        logits = L.unembed_apply(params["embed"], cfg, x)
        return logits, aux

    def loss(self, params, batch, *, remat: bool = True):
        """(cross-entropy of ``batch["labels"]`` plus the aux loss, {"ce",
        "aux", "tokens"}), each a 0-d f32 tensor."""
        logits, aux = self.forward(params, batch, remat=remat)
        ce, denom = cross_entropy(logits, batch["labels"],
                                  impl=self.cfg.ce_impl)
        return ce + aux, {"ce": ce, "aux": aux, "tokens": denom}

    # -- serving ---------------------------------------------------------------
    def prefill(self, params, batch, *, remat: bool = False):
        """(logits (B, 1, V) of the last position, caches of every one)."""
        cfg = self.cfg
        x, positions = self._embed_inputs(params, batch)
        x, caches, _ = trunk.trunk_apply(params["trunk"], cfg, x,
                                         positions=positions, want_cache=True,
                                         remat=remat)
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


class EncDecModel(Model):
    """Whisper-style encoder-decoder: batches carry ``frames`` (B, S_enc,
    d) beside ``tokens``; the caches hold each decoder layer's self K/V
    and the cross K/V of the encoder memory."""

    def param_meta(self) -> Dict[str, Any]:
        return whisper.whisper_meta(self.cfg)

    def cache_meta(self, batch: int, seq: int) -> Dict[str, Any]:
        return whisper.whisper_cache_meta(self.cfg, batch, seq)

    def forward(self, params, batch, *, remat: bool = False):
        cfg = self.cfg
        memory = whisper.encode(params, cfg, batch["frames"], remat=remat)
        x, _ = whisper.decode_stack(params, cfg, batch["tokens"],
                                    memory=memory, remat=remat)
        logits = L.unembed_apply(params["embed"], cfg, x)
        return logits, torch.zeros((), dtype=f32, device=logits.device)

    def prefill(self, params, batch, *, remat: bool = False):
        cfg = self.cfg
        memory = whisper.encode(params, cfg, batch["frames"], remat=remat)
        x, caches = whisper.decode_stack(params, cfg, batch["tokens"],
                                         memory=memory, want_cache=True,
                                         remat=remat)
        logits = L.unembed_apply(params["embed"], cfg, x[:, -1:])
        return logits, caches

    def decode(self, params, caches, batch):
        cfg = self.cfg
        x, caches = whisper.decode_stack(params, cfg, batch["tokens"],
                                         caches=caches, index=batch["index"])
        logits = L.unembed_apply(params["embed"], cfg, x)
        return logits, caches


def build_model(cfg: ModelConfig) -> Model:
    """The port's model for ``cfg``: an :class:`EncDecModel` for an
    encoder-decoder config, else a :class:`Model`."""
    if cfg.is_encoder_decoder:
        return EncDecModel(cfg)
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
        if cfg.is_encoder_decoder:
            enc_len = max(S // cfg.encoder_downsample, 1)
            specs["frames"] = _spec((B, enc_len, cfg.d_model), bf)
            specs["tokens"] = _spec((B, S), i32)
        elif cfg.frontend == "vision_patches":
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
