"""mamba2-780m  [ssm]  48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128.  SSD (state-space duality).  [arXiv:2405.21060]

d_inner = expand*d_model = 3072, head_dim 64 -> 48 SSD heads/layer.
Attention-free: runs long_500k (sub-quadratic by construction).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=1536,
    num_heads=24,          # unused by SSD blocks; kept for interface parity
    num_kv_heads=24,
    d_ff=0,
    vocab_size=50_280,
    use_rope=False,
    ssm=SSMConfig(
        state_dim=128,
        conv_width=4,
        expand=2,
        head_dim=64,
        chunk_size=256,
        n_groups=1,
    ),
    act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
)
