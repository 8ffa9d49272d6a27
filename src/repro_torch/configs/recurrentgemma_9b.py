"""recurrentgemma-9b  [hybrid]  38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000.  RG-LRU + local attention, 2 recurrent : 1 local.
[arXiv:2402.19427] (Griffin).

Sub-quadratic (recurrence + bounded local window) -> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    source="arXiv:2402.19427",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    layer_pattern=("recurrent", "recurrent", "local"),
    sliding_window=2048,
    rglru=RGLRUConfig(lru_width=4096, conv_width=4, block_width=256),
    act="gelu_glu",
    norm="rmsnorm",
    embedding_scale=True,
    tie_embeddings=True,
    grad_accum=2,
)
