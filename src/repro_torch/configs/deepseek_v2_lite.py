"""deepseek-v2-lite-16b — MLA (kv_lora=512) + MoE 64 routed top-6,
2 shared experts, first layer dense.  [arXiv:2405.04434]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,          # MLA: per-head K/V reconstructed from c_kv
    d_ff=10944,               # dense first layer FFN
    vocab_size=102400,
    activation="silu_gated",
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    citation="arXiv:2405.04434",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-reduced", family="moe", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=512,
        activation="silu_gated", num_experts=4, num_shared_experts=1,
        top_k=2, moe_d_ff=128, first_dense_layers=1, kv_lora_rank=64,
        qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
        param_dtype="float32", citation=CONFIG.citation)
