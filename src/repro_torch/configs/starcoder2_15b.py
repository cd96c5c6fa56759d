"""starcoder2-15b — dense GQA kv=4, RoPE, GELU MLP with biases.
[arXiv:2402.19173]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    activation="gelu",
    use_bias=True,
    rope_theta=100_000.0,
    citation="arXiv:2402.19173",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-reduced", family="dense", num_layers=2, d_model=256,
        num_heads=8, num_kv_heads=2, d_ff=1024, vocab_size=512,
        activation="gelu", use_bias=True, param_dtype="float32",
        citation=CONFIG.citation)
