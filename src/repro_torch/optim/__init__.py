"""Functional optimizers of the port (``repro.optim``'s SGD, Adam,
AdamW and Adafactor)."""

from .optimizer import (AdafactorState, AdamState, Optimizer, adafactor,
                        adam, adamw, from_jax_opt_state, sgd)

__all__ = ["AdafactorState", "AdamState", "Optimizer", "sgd", "adam",
           "adamw", "adafactor", "from_jax_opt_state"]
