"""Input-shape variants and training defaults of the LM zoo.

Counterpart of the single-device helpers of ``repro/launch/steps.py``:
the long-context sliding-window variant and the cache capacity it
implies, the gradient-accumulation factor of a training shape and each
config's optimizer.  The sharded step builders of that module belong to
the pod-tooling item of the ROADMAP and are not ported.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.optim import Optimizer, adafactor, adamw

# long-context attention variant: ring-buffer sliding window
LONG_CONTEXT_WINDOW = 8192


def default_microbatches(cfg: ModelConfig, shape: InputShape) -> int:
    """Gradient-accumulation factor of a training shape, by the model's
    width class and family (the JAX package's table, sized for the
    saved activations of its pod runs); 1 for any other shape."""
    if shape.kind != "train":
        return 1
    if cfg.d_model >= 8192:
        return 16
    if cfg.family in ("ssm", "hybrid"):
        return 8           # SSD intra-chunk buffers dominate saved memory
    if cfg.d_model >= 6144 or cfg.family == "vlm":
        return 8
    if cfg.num_experts:
        return 8
    return 4


def make_optimizer(cfg: ModelConfig) -> Optimizer:
    """Adafactor(1e-3) where the config asks for it (the 340B-class
    configs), else AdamW(3e-4)."""
    return adafactor(1e-3) if cfg.optimizer == "adafactor" else adamw(3e-4)


def shape_variant(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Apply the long-context SWA variant for attention architectures."""
    if shape.name == "long_500k" and cfg.family != "ssm" \
            and cfg.sliding_window is None:
        return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def cache_capacity(cfg: ModelConfig, shape: InputShape) -> int:
    cap = shape.seq_len
    if cfg.sliding_window is not None:
        cap = min(cap, cfg.sliding_window)
    return cap
