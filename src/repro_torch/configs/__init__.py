"""Assigned-architecture registry of the port (a copy of ``repro.configs``).

``get_config(name)`` resolves any of the 10 assigned architectures.
``reduced(config)`` shrinks a config to a CPU-smoke-test scale preserving
the family (GQA ratios, MoE top-k, patterns).  Which configs the port can
build today is :func:`repro_torch.models.model_zoo.build_model`'s to say.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES_BY_NAME,
    TRAIN_4K,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    RGLRUConfig,
    ShapeCell,
    SSMConfig,
)

from repro_torch.configs.qwen3_4b import CONFIG as QWEN3_4B
from repro_torch.configs.gemma2_9b import CONFIG as GEMMA2_9B
from repro_torch.configs.tinyllama_1_1b import CONFIG as TINYLLAMA_1_1B
from repro_torch.configs.mistral_nemo_12b import CONFIG as MISTRAL_NEMO_12B
from repro_torch.configs.mamba2_780m import CONFIG as MAMBA2_780M
from repro_torch.configs.whisper_small import CONFIG as WHISPER_SMALL
from repro_torch.configs.recurrentgemma_9b import CONFIG as RECURRENTGEMMA_9B
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as DEEPSEEK_V2_LITE_16B
from repro_torch.configs.deepseek_v3_671b import CONFIG as DEEPSEEK_V3_671B
from repro_torch.configs.internvl2_1b import CONFIG as INTERNVL2_1B

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        QWEN3_4B,
        GEMMA2_9B,
        TINYLLAMA_1_1B,
        MISTRAL_NEMO_12B,
        MAMBA2_780M,
        WHISPER_SMALL,
        RECURRENTGEMMA_9B,
        DEEPSEEK_V2_LITE_16B,
        DEEPSEEK_V3_671B,
        INTERNVL2_1B,
    )
}

ARCH_NAMES: Tuple[str, ...] = tuple(ARCHS)


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {', '.join(ARCH_NAMES)}"
        ) from None


def reduced(cfg: ModelConfig, *, layers: int = 2, vocab: int = 512) -> ModelConfig:
    """Shrink to smoke-test scale, preserving the family structure."""
    d_model = 128
    heads = 4
    # keep the GQA ratio
    ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
    kv = max(1, heads // ratio)
    kw: dict = dict(
        num_layers=max(layers, len(cfg.layer_pattern)),
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=vocab,
        grad_accum=min(cfg.grad_accum, 2),
        max_position_embeddings=4096,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=8,
            experts_per_token=min(cfg.moe.experts_per_token, 2),
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            d_ff=64,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
            dense_d_ff=256,
            group_size=64,
        )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(
            kv_lora_rank=32, q_lora_rank=(16 if cfg.mla.q_lora_rank else 0),
            rope_head_dim=16, nope_head_dim=32, v_head_dim=32,
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=16, head_dim=16, chunk_size=32)
    if cfg.rglru is not None:
        kw["rglru"] = RGLRUConfig(lru_width=128, conv_width=4, block_width=32)
    if cfg.is_encoder_decoder:
        kw["encoder_layers"] = layers
    if cfg.sliding_window:
        kw["sliding_window"] = 16
    if cfg.frontend_tokens:
        kw["frontend_tokens"] = 8
    return cfg.replace(**kw)


__all__ = [
    "ALL_SHAPES", "SHAPES_BY_NAME", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
    "LONG_500K", "ShapeCell", "ModelConfig", "MoEConfig", "MLAConfig",
    "SSMConfig", "RGLRUConfig", "ARCHS", "ARCH_NAMES", "get_config", "reduced",
]
