"""smollm-360m — llama-architecture small dense model, GQA kv=5.
[hf:HuggingFaceTB/SmolLM-135M (family card; 360M variant numbers)]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    activation="silu_gated",
    tie_embeddings=True,
    citation="hf:HuggingFaceTB/SmolLM-135M",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="smollm-reduced", family="dense", num_layers=2, d_model=192,
        num_heads=3, num_kv_heads=1, d_ff=512, vocab_size=512,
        activation="silu_gated", tie_embeddings=True, param_dtype="float32",
        citation=CONFIG.citation)
