"""command-r-35b — dense GQA kv=8, no biases anywhere.
[hf:CohereForAI/c4ai-command-r-v01]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    activation="silu_gated",
    use_bias=False,
    rope_theta=8_000_000.0,
    citation="hf:CohereForAI/c4ai-command-r-v01",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="command-r-reduced", family="dense", num_layers=2, d_model=256,
        num_heads=8, num_kv_heads=2, d_ff=768, vocab_size=512,
        activation="silu_gated", use_bias=False, param_dtype="float32",
        citation=CONFIG.citation)
