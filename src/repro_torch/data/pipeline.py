"""Deterministic synthetic token streams for the architecture zoo.

Counterpart of ``repro/data/pipeline.py``, on numpy: the same generator
calls in the same order, so the tokens are byte-identical to the JAX
package's.  Batches are seeded synthetic token streams with a learnable
structure (a noisy Markov chain over the vocab).  The training batches
(``synthetic_batches``) wait for the training slice of the LM zoo.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

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


def synthetic_request_stream(cfg: ModelConfig, *, batch: int,
                             prompt_len: int, seed: int = 0
                             ) -> Iterator[np.ndarray]:
    """Batched serve requests: (batch, prompt_len) int64 token prompts."""
    rng = np.random.default_rng(seed)
    while True:
        yield _markov_tokens(rng, cfg.vocab_size, batch, prompt_len)
