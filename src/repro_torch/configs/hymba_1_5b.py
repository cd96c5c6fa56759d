"""hymba-1.5b — hybrid-head: parallel attention + mamba heads per layer.
[arXiv:2411.13676]

Each layer feeds the same normed input to a GQA attention branch and an
SSD branch; outputs are mean-fused.  The SSM branch keeps long_500k
sub-quadratic; the attention branch uses a sliding window there.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    activation="silu_gated",
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    sliding_window=8192,
    citation="arXiv:2411.13676",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="hymba-reduced", family="hybrid", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=512,
        activation="silu_gated", ssm_state=16, ssm_head_dim=32,
        ssm_expand=2, ssm_chunk=64, sliding_window=128,
        param_dtype="float32", citation=CONFIG.citation)
