"""Deterministic synthetic token streams for the architecture zoo.

Counterpart of ``repro/data/pipeline.py``: the same numpy generator
calls in the same order, so tokens and modality inputs are
byte-identical to the JAX package's.  Batches are seeded synthetic token
streams with a learnable structure (a noisy Markov chain over the vocab),
plus the VLM's and audio's stub inputs (precomputed patch and frame
embeddings).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _markov_tokens(rng: np.random.Generator, vocab: int, batch: int,
                   seq: int, order_stride: int = 7) -> np.ndarray:
    """Tokens with predictable structure: t_{i+1} ≈ (a·t_i + b) mod V with
    noise — a next-token pattern a small model can actually learn."""
    toks = np.empty((batch, seq), np.int64)
    toks[:, 0] = rng.integers(0, vocab, batch)
    noise = rng.random((batch, seq)) < 0.15
    rand = rng.integers(0, vocab, (batch, seq))
    for i in range(1, seq):
        nxt = (toks[:, i - 1] * order_stride + 13) % vocab
        toks[:, i] = np.where(noise[:, i], rand[:, i], nxt)
    return toks


def synthetic_batches(cfg: ModelConfig, *, batch: int, seq: int,
                      seed: int = 0, device: str = "cuda"
                      ) -> Iterator[dict]:
    """Forward / training batches on ``device``: "tokens" and "labels"
    (batch, seq) int32, the labels the tokens shifted by one; for the VLM
    "vision" (batch, vision_tokens, vision_dim) and for audio "frames"
    (batch, encoder_seq, d_model), normal·0.1 rounded to fp32 and then to
    the config's dtype."""
    rng = np.random.default_rng(seed)

    def stub(shape):
        a = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        return torch.from_numpy(a).to(device=device, dtype=cfg.dtype)

    while True:
        toks = _markov_tokens(rng, cfg.vocab_size, batch, seq + 1)
        out = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32))
               .to(device),
               "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))
               .to(device)}
        if cfg.family == "vlm":
            out["vision"] = stub((batch, cfg.vision_tokens, cfg.vision_dim))
        if cfg.family == "audio":
            out["frames"] = stub((batch, cfg.encoder_seq, cfg.d_model))
        yield out


def synthetic_request_stream(cfg: ModelConfig, *, batch: int,
                             prompt_len: int, seed: int = 0
                             ) -> Iterator[np.ndarray]:
    """Batched serve requests: (batch, prompt_len) int64 token prompts."""
    rng = np.random.default_rng(seed)
    while True:
        yield _markov_tokens(rng, cfg.vocab_size, batch, prompt_len)
