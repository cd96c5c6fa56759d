"""Functional optimizers of the port (``repro.optim``'s Adam)."""

from .optimizer import AdamState, Optimizer, adam

__all__ = ["AdamState", "Optimizer", "adam"]
