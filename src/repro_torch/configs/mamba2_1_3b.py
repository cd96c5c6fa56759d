"""mamba2-1.3b — attention-free SSD (state-space duality). [arXiv:2405.21060]

d_inner = 2·d_model, 64-dim SSD heads, d_state=128.  Decode state is O(1)
per layer, so the long_500k shape runs natively (no window needed).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
    citation="arXiv:2405.21060",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-reduced", family="ssm", num_layers=2, d_model=256,
        num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=512,
        ssm_state=16, ssm_head_dim=32, ssm_expand=2, ssm_chunk=64,
        tie_embeddings=True, param_dtype="float32", citation=CONFIG.citation)
