"""gemma2-9b  [dense]  42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.

local+global alternating attention, logit softcapping.  [arXiv:2408.00118; hf]
head_dim=256, sliding window 4096, attn softcap 50.0, final softcap 30.0,
GeGLU, post-block norms, sqrt(d_model) embedding scaling.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    source="arXiv:2408.00118",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256_000,
    layer_pattern=("local", "global"),
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu_glu",
    norm="rmsnorm",
    post_attn_norm=True,
    embedding_scale=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    grad_accum=2,
    skip_shapes=(
        ("long_500k", "alternating layers include GLOBAL full attention; "
                      "524k dense KV decode excluded per shape definition"),
    ),
)
