"""deepseek-v3-671b  [moe]  61L d_model=7168 128H d_ff=2048 vocab=129280,
MLA (kv_lora=512, q_lora=1536), 1 shared + 256 routed experts top-8, MTP.
[arXiv:2412.19437]

First 3 layers dense (d_ff 18432); remaining 58 MoE, per-expert width 2048.
MTP (multi-token prediction) is available as an optional extra head in the
model zoo (``extra_targets``) but is disabled for the graded dry-run cells.
grad_accum=8 keeps the per-microbatch dispatch footprint within a v5e HBM.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    source="arXiv:2412.19437",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=2048,
    vocab_size=129_280,
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        experts_per_token=8,
        num_shared_experts=1,
        d_ff=2048,
        first_dense_layers=3,
        dense_d_ff=18_432,
        capacity_factor=1.25,
        group_size=4_096,
    ),
    act="silu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    grad_accum=8,
    param_dtype="bfloat16",        # bf16 weights: a 671B f32 master cannot fit
    opt_moment_dtype="bfloat16",   # ZeRO-sharded moments; bf16 keeps 671B in HBM
    # 2-D expert parallelism: 256 routed experts shard over data x model
    # (256 ways on one pod; the pod axis adds ZeRO-1 on the moments).
    sharding_overrides=(("expert", ("data", "model")),
                        ("vocab", ("data", "model"))),
    skip_shapes=(
        ("long_500k", "pure full attention (MLA): 524k dense-cache decode "
                      "excluded per shape definition"),
    ),
)
