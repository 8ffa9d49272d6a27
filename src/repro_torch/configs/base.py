"""Config system of the port's model zoo (a copy of ``repro/configs/base.py``).

Every assigned architecture is a frozen dataclass instance of
:class:`ModelConfig`.  Configs are pure data: this module imports no
tensor library, so every field, pattern and parameter count is the
reference's, value for value.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Tuple

# ---------------------------------------------------------------------------
# Shape cells (assigned input shapes, identical for every LM-family arch)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell.

    ``kind`` selects which step function the cell lowers:
      * ``train``   -> ``train_step``   (tokens+labels, full fwd/bwd/update)
      * ``prefill`` -> ``prefill_step`` (tokens -> logits + KV cache)
      * ``decode``  -> ``decode_step``  (1 new token against a seq_len cache)
    """

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeCell("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeCell("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeCell("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeCell("long_500k", 524_288, 1, "decode")

ALL_SHAPES: Tuple[ShapeCell, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME: Mapping[str, ShapeCell] = {s.name: s for s in ALL_SHAPES}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0              # routed experts
    experts_per_token: int = 0        # top-k
    num_shared_experts: int = 0
    d_ff: int = 0                     # per-expert hidden width
    first_dense_layers: int = 0       # leading layers that stay dense
    dense_d_ff: int = 0               # hidden width of those dense layers
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    group_size: int = 4_096           # tokens per dispatch group
    aux_loss_weight: float = 0.001
    scan_groups: bool = False         # §Perf: sequential groups — one group's
                                      # (G,E,C,d) dispatch buffers live at a time
    ep_major: bool = False            # §Perf: shard dispatched activations
                                      # expert-major (match 2D expert weights;
                                      # reshard 1.9GB tokens, not 11GB weights)


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek V2/V3)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0              # 0 -> direct q projection
    rope_head_dim: int = 64           # decoupled-RoPE dims (shared k)
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block config."""

    state_dim: int = 128
    conv_width: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256
    n_groups: int = 1


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU block config."""

    lru_width: int = 0                # 0 -> d_model
    conv_width: int = 4
    block_width: int = 256            # scan chunk for the linear recurrence


@dataclass(frozen=True)
class ModelConfig:
    # identity -----------------------------------------------------------
    name: str = "unnamed"
    family: str = "dense"  # dense | ssm | hybrid | moe | audio | vlm
    source: str = ""       # citation tag from the assignment table

    # trunk ---------------------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0      # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    # attention variants --------------------------------------------------
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    # repeating block pattern, cycled over layers: entries in
    # {"global", "local", "recurrent"}.
    layer_pattern: Tuple[str, ...] = ("global",)
    rope_theta: float = 10_000.0
    use_rope: bool = True
    learned_pos_embed: bool = False
    max_position_embeddings: int = 1 << 20

    # sub-configs (None when inapplicable) --------------------------------
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None

    # enc-dec -------------------------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_downsample: int = 1      # stubbed conv-frontend time downsampling

    # modality frontend stub ----------------------------------------------
    frontend: str = "none"           # none | audio_frames | vision_patches
    frontend_tokens: int = 0         # prepended stub-embedding tokens (vlm)

    # norms / activations --------------------------------------------------
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu | gelu
    norm_eps: float = 1e-6
    post_attn_norm: bool = False     # gemma2-style post-block norms
    tie_embeddings: bool = False
    embedding_scale: bool = False    # gemma-style sqrt(d_model) embed scaling

    # numerics / training --------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"              # none | full | dots
    scan_layers: bool = True
    grad_accum: int = 1              # microbatches per train step
    opt_moment_dtype: str = "float32"
    ce_impl: str = "gather"          # gather | onehot (§Perf: vocab-sharded CE)
    norm_mixed: bool = False         # §Perf: f32 statistics, bf16 apply — stops
                                     # XLA hoisting a full f32 copy of the
                                     # stacked remat saves out of the bwd loop
    attn_p_bf16: bool = False        # §Perf: attention probability blocks at
                                     # bf16 fusion boundaries (stats stay f32)
    attn_q_chunk: int = 512          # §Perf: flash q-block rows
    attn_kv_chunk: int = 1024        # §Perf: flash kv-block rows (larger ->
                                     # fewer f32 accumulator rewrites)

    # distribution ---------------------------------------------------------
    # logical->mesh axis overrides merged over DEFAULT_SHARDING_RULES
    sharding_overrides: Tuple[Tuple[str, Any], ...] = ()
    # shape-cell names this arch skips, with reasons
    skip_shapes: Tuple[Tuple[str, str], ...] = ()

    # ---------------------------------------------------------------------
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def pattern_for(self, num_layers: int) -> Tuple[str, ...]:
        p = self.layer_pattern
        return tuple(p[i % len(p)] for i in range(num_layers))

    def skipped(self, shape_name: str) -> Optional[str]:
        for name, reason in self.skip_shapes:
            if name == shape_name:
                return reason
        return None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (used for MODEL_FLOPS = 6 N D) -----------------
    def param_counts(self) -> Mapping[str, int]:
        """Analytic parameter counts: total and active (MoE-aware)."""
        d, hd = self.d_model, self.resolved_head_dim()
        nl = self.num_layers

        def attn_params() -> int:
            if self.mla is not None:
                m = self.mla
                q_in = m.q_lora_rank if m.q_lora_rank else d
                p = 0
                if m.q_lora_rank:
                    p += d * m.q_lora_rank
                p += q_in * self.num_heads * (m.nope_head_dim + m.rope_head_dim)
                p += d * (m.kv_lora_rank + m.rope_head_dim)        # compressed kv + rope k
                p += m.kv_lora_rank * self.num_heads * (m.nope_head_dim + m.v_head_dim)
                p += self.num_heads * m.v_head_dim * d             # o proj
                return p
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            return q + kv + o

        def dense_ffn(width: int) -> int:
            if self.act in ("silu", "gelu_glu"):
                return 3 * d * width  # gated
            return 2 * d * width

        def block_params(kind: str, layer_idx: int) -> Tuple[int, int]:
            """(total, active) for one block."""
            if kind == "recurrent":
                r = self.rglru or RGLRUConfig()
                w = r.lru_width or d
                # in/out proj (x2 branches), conv, gates (a, input), out
                p = 2 * d * w + r.conv_width * w + 2 * w * w + w * d
                return p, p
            if self.ssm is not None and self.family == "ssm":
                s = self.ssm
                d_in = s.expand * d
                nheads = d_in // s.head_dim
                p = d * (2 * d_in + 2 * s.n_groups * s.state_dim + nheads)
                p += s.conv_width * (d_in + 2 * s.n_groups * s.state_dim)
                p += nheads * 2  # A_log, D
                p += d_in * d    # out proj
                return p, p
            a = attn_params()
            if self.moe is not None and layer_idx >= self.moe.first_dense_layers:
                mo = self.moe
                per_exp = 3 * d * mo.d_ff
                total = a + (mo.num_experts + mo.num_shared_experts) * per_exp
                total += d * mo.num_experts  # router
                active = a + (mo.experts_per_token + mo.num_shared_experts) * per_exp
                return total, active
            width = self.d_ff
            if self.moe is not None and layer_idx < self.moe.first_dense_layers:
                width = self.moe.dense_d_ff or self.d_ff
            f = dense_ffn(width)
            return a + f, a + f

        pattern = self.pattern_for(nl)
        total = active = 0
        for i, kind in enumerate(pattern):
            t, ac = block_params(kind, i)
            total += t
            active += ac
        if self.is_encoder_decoder:
            # encoder self-attn blocks + decoder cross-attn additions
            enc = self.encoder_layers * (attn_params() + dense_ffn(self.d_ff))
            cross = nl * attn_params()
            total += enc + cross
            active += enc + cross
        embed = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        return {
            "total": total + embed + head,
            "active": active + embed + head,
            "embedding": embed + head,
            "trunk_total": total,
            "trunk_active": active,
        }
