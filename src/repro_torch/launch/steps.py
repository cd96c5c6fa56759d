"""Input-shape variants of the LM zoo.

Counterpart of the shape helpers of ``repro/launch/steps.py``: the
long-context sliding-window variant and the cache capacity it implies.
The sharded step builders of that module belong to the pod-tooling item
of the ROADMAP and are not ported.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import InputShape, ModelConfig

# long-context attention variant: ring-buffer sliding window
LONG_CONTEXT_WINDOW = 8192


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
