"""Checkpoints in the JAX package's file format (``repro.checkpoint``)."""

from .checkpoint import load_pytree, restore, save, save_pytree

__all__ = ["save", "restore", "save_pytree", "load_pytree"]
