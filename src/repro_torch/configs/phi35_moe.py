"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE, GQA kv=8.
[hf:microsoft/Phi-3.5-MoE-instruct]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    activation="silu_gated",
    num_experts=16,
    top_k=2,
    moe_d_ff=6400,
    optimizer="adamw",
    citation="hf:microsoft/Phi-3.5-MoE-instruct",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-reduced", family="moe", num_layers=2, d_model=256,
        num_heads=8, num_kv_heads=2, d_ff=512, vocab_size=512,
        activation="silu_gated", num_experts=4, top_k=2, moe_d_ff=512,
        param_dtype="float32", citation=CONFIG.citation)
