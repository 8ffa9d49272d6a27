"""deepseek-v2-lite-16b  [moe]  27L d_model=2048 16H d_ff=1408 vocab=102400,
MLA kv_lora=512, 2 shared + 64 routed experts top-6.  [arXiv:2405.04434]

First layer dense (d_ff 10944), remaining 26 layers MoE with per-expert
hidden width 1408 (the assignment's d_ff).  No q-LoRA in the Lite variant.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    source="arXiv:2405.04434",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=64,
        experts_per_token=6,
        num_shared_experts=2,
        d_ff=1408,
        first_dense_layers=1,
        dense_d_ff=10_944,
        capacity_factor=1.25,
        group_size=4_096,
    ),
    act="silu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    grad_accum=2,
    skip_shapes=(
        ("long_500k", "pure full attention (MLA is still softmax attention "
                      "over all positions): 524k dense-cache decode excluded"),
    ),
)
