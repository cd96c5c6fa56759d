"""llama-3.2-vision-11b — dense GQA decoder with cross-attention image
layers every 5th layer.  [hf:meta-llama/Llama-3.2-11B-Vision]

The ViT vision encoder + projector is the allowed STUB: input_specs()
provides precomputed patch embeddings (B, vision_tokens, vision_dim); the
model owns only the projector into d_model and the language stack.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    activation="silu_gated",
    rope_theta=500_000.0,
    cross_attn_every=5,
    vision_tokens=1600,
    vision_dim=1280,
    citation="hf:meta-llama/Llama-3.2-11B-Vision",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama-vision-reduced", family="vlm", num_layers=2, d_model=256,
        num_heads=8, num_kv_heads=2, d_ff=512, vocab_size=512,
        activation="silu_gated", cross_attn_every=2, vision_tokens=16,
        vision_dim=64, param_dtype="float32", citation=CONFIG.citation)
