"""qwen3-4b  [dense]  36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.

qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]  (4B-scale Qwen3 trunk; head_dim=128
per the Qwen3 family spec, explicit because 2560/32 != 128).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
    grad_accum=1,
    skip_shapes=(
        ("long_500k", "pure full attention: 524k dense KV decode is the "
                      "quadratic-memory regime this shape excludes"),
    ),
)
