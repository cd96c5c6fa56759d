"""whisper-tiny — encoder-decoder with conv/mel frontend STUB.
[arXiv:2212.04356]

The mel-spectrogram + conv feature extractor is the allowed stub:
input_specs() provides precomputed frame embeddings (B, encoder_seq,
d_model).  We implement the transformer encoder + causal decoder with
cross-attention (the backbone).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,            # decoder layers
    encoder_layers=4,
    encoder_seq=1500,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    activation="gelu",
    use_bias=True,
    citation="arXiv:2212.04356",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-reduced", family="audio", num_layers=2,
        encoder_layers=2, encoder_seq=64, d_model=128, num_heads=4,
        num_kv_heads=4, d_ff=256, vocab_size=512, activation="gelu",
        use_bias=True, param_dtype="float32", citation=CONFIG.citation)
