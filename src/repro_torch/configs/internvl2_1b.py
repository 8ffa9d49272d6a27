"""internvl2-1b  [vlm]  24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.

InternViT + InternLM2/Qwen2-0.5B backbone.  [arXiv:2404.16821]
The vision frontend (InternViT) is a STUB: ``input_specs()`` provides
precomputed patch embeddings (256 visual tokens) prepended to the text.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    source="arXiv:2404.16821",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_655,
    frontend="vision_patches",
    frontend_tokens=256,
    act="silu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    skip_shapes=(
        ("long_500k", "pure full attention: 524k dense KV decode is the "
                      "quadratic-memory regime this shape excludes"),
    ),
)
