"""GNN inference serving of the port: hot-embedding cache, query batcher
and the early-exit shard engine (port of ``repro.gnnserve``)."""

from .batcher import QueryBatcher, ServedResult
from .cache import HotEmbeddingCache
from .engine import ServingPlane, ShardServeEngine, build_serving

__all__ = ["QueryBatcher", "ServedResult", "HotEmbeddingCache",
           "ServingPlane", "ShardServeEngine", "build_serving"]
