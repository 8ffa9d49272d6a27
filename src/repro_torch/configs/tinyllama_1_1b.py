"""tinyllama-1.1b  [dense]  22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.

llama2-architecture small model.  [arXiv:2401.02385; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    source="arXiv:2401.02385",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32_000,
    act="silu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    skip_shapes=(
        ("long_500k", "pure full attention: 524k dense KV decode is the "
                      "quadratic-memory regime this shape excludes"),
    ),
)
