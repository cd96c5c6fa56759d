"""Remote-embedding exchange of the port: wire codecs, transports and the
per-client facade (port of ``repro.exchange``)."""

from .client import ExchangeClient, PushPlan
from .codec import (Fp16Codec, Fp32Codec, Int8Codec, WireCodec,
                    available_codecs, get_codec)
from .transport import (HashShardedWire, InProcessTransport,
                        ShardedTransport, Transport, make_transport)

__all__ = ["ExchangeClient", "PushPlan", "Fp16Codec", "Fp32Codec",
           "Int8Codec", "WireCodec", "available_codecs", "get_codec",
           "HashShardedWire", "InProcessTransport", "ShardedTransport",
           "Transport", "make_transport"]
