"""Seeded synthetic request streams for the LM serving path."""

from .pipeline import synthetic_request_stream

__all__ = ["synthetic_request_stream"]
