"""whisper-small  [audio]  12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865.

Encoder-decoder; conv frontend is a STUB: ``input_specs()`` provides
precomputed frame embeddings (post-conv, 2x time-downsampled).
[arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=12,            # decoder layers
    encoder_layers=12,
    is_encoder_decoder=True,
    encoder_downsample=2,     # stubbed conv stem stride
    frontend="audio_frames",
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51_865,
    use_rope=False,
    learned_pos_embed=True,
    max_position_embeddings=65_536,
    act="gelu",
    norm="layernorm",
    tie_embeddings=True,
    skip_shapes=(
        ("long_500k", "pure full attention (enc-dec): 524k dense KV decode "
                      "is the quadratic-memory regime this shape excludes"),
    ),
)
