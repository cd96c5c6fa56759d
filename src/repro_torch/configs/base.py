"""Model/shape configuration schema for the architecture zoo.

Counterpart of ``repro/configs/base.py``, field for field; only
:attr:`ModelConfig.dtype` differs, returning a torch dtype.

Every assigned architecture gets a ``configs/<id>.py`` exposing
``CONFIG`` (the exact published numbers, cited) plus ``reduced()`` (a
≤2-layer, d_model≤512, ≤4-expert variant of the same family for CPU smoke
tests).  Input shapes are the four assigned workload points.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 ⇒ d_model // num_heads
    activation: str = "silu_gated"   # silu_gated | squared_relu | gelu
    use_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # attention variant
    sliding_window: Optional[int] = None   # ring-buffer window for long ctx
    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0      # deepseek: layer 0 is dense FFN
    capacity_factor: float = 1.25
    # 0/1 = one global dispatch group (paper-faithful baseline).  >1 =
    # grouped dispatch: sort/scatter stay local to each (data-sharded)
    # token group and only the expert einsum crosses shards (all-to-all)
    # — the §Perf fix for the MoE collective bottleneck.
    moe_groups: int = 0
    # MLA (deepseek)
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    # VLM
    cross_attn_every: int = 0        # a cross-attn layer every N layers
    vision_tokens: int = 0
    vision_dim: int = 0
    # audio (enc-dec)
    encoder_layers: int = 0
    encoder_seq: int = 0             # precomputed frame embeddings length
    # numerics / optimizer
    param_dtype: str = "bfloat16"
    optimizer: str = "adamw"         # adamw | adafactor (340B-scale)
    remat: bool = True
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.param_dtype == "bfloat16" \
            else torch.float32

    @property
    def is_encdec(self) -> bool:
        return self.family == "audio"

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS = 6·N·D)."""
        D, F, V, H = self.d_model, self.d_ff, self.vocab_size, self.num_heads
        dh = self.resolved_head_dim
        kvh = self.num_kv_heads
        n = V * D * (1 if self.tie_embeddings else 2)

        def attn_p():
            if self.kv_lora_rank:  # MLA
                qd = self.qk_nope_head_dim + self.qk_rope_head_dim
                return (D * H * qd + D * (self.kv_lora_rank + self.qk_rope_head_dim)
                        + self.kv_lora_rank * H * (self.qk_nope_head_dim
                                                   + self.v_head_dim)
                        + H * self.v_head_dim * D)
            return D * H * dh + 2 * D * kvh * dh + H * dh * D

        def mlp_p(ff):
            mult = 3 if self.activation == "silu_gated" else 2
            return mult * D * ff

        def ssm_p():
            d_in = self.ssm_expand * D
            nh = d_in // self.ssm_head_dim
            return (D * (2 * d_in + 2 * self.ssm_state + nh)
                    + d_in * D + 3 * nh + d_in)

        per_layer = 2 * D  # norms
        if self.family == "ssm":
            n += self.num_layers * (ssm_p() + D)
            return n
        if self.family == "hybrid":
            n += self.num_layers * (attn_p() + ssm_p() + mlp_p(F) + 3 * D)
            return n
        moe_layers = max(0, self.num_layers - self.first_dense_layers) \
            if self.num_experts else 0
        dense_layers = self.num_layers - moe_layers
        n += dense_layers * (attn_p() + mlp_p(F) + per_layer)
        if moe_layers:
            expert = mlp_p(self.moe_d_ff)
            n += moe_layers * (attn_p() + D * self.num_experts
                               + self.num_experts * expert
                               + self.num_shared_experts * expert + per_layer)
        if self.cross_attn_every:
            n_cross = self.num_layers // self.cross_attn_every
            n += n_cross * (attn_p() + D)
        if self.encoder_layers:
            n += self.encoder_layers * (attn_p() + mlp_p(F) + per_layer)
            n += self.num_layers * (attn_p() + D)  # decoder cross-attn
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        mult = 3 if self.activation == "silu_gated" else 2
        expert = mult * self.d_model * self.moe_d_ff
        moe_layers = self.num_layers - self.first_dense_layers
        inactive = moe_layers * (self.num_experts - self.top_k) * expert
        return full - inactive


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}
