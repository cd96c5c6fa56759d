"""The int8 codec kernels' (rows 1–4: encode, decode, gather-encode,
decode-scatter) share of their roofline over the window's launches."""

from perfbench.metrics._example import base
from perfbench.metrics._read import CODEC_KERNELS, roofline


def read(rec):
    return roofline(rec, "codec_bytes", CODEC_KERNELS)


def example():
    """125 bytes at 1 kB/s over 0.25 s of its kernels."""
    return base(), (125 / 1e3) / 0.25 * 100
