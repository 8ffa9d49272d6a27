"""mistral-nemo-12b  [dense]  40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072.  128k context.  [hf:mistralai/Mistral-Nemo-Base-2407; hf]
head_dim=128, rope_theta=1e6 for long context.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    source="hf:mistralai/Mistral-Nemo-Base-2407",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131_072,
    act="silu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    grad_accum=2,
    skip_shapes=(
        ("long_500k", "pure full attention: 524k dense KV decode is the "
                      "quadratic-memory regime this shape excludes"),
    ),
)
