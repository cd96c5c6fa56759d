"""Seeded synthetic batches and request streams for the LM zoo."""

from .pipeline import synthetic_batches, synthetic_request_stream

__all__ = ["synthetic_batches", "synthetic_request_stream"]
