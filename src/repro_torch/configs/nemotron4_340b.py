"""nemotron-4-340b — dense GQA kv=8, squared-ReLU MLP. [arXiv:2402.16819]

340B params on 256 chips needs factored optimizer state (adafactor) and
sequence-parallel residual sharding — see DESIGN.md §4 and the sharding
rules in repro.distributed.sharding.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    activation="squared_relu",
    rope_theta=10_000.0,
    optimizer="adafactor",
    citation="arXiv:2402.16819",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="nemotron-reduced", family="dense", num_layers=2, d_model=256,
        num_heads=8, num_kv_heads=2, d_ff=1024, vocab_size=512,
        activation="squared_relu", param_dtype="float32",
        optimizer="adafactor", citation=CONFIG.citation)
