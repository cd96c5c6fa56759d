"""GNN inference serving of the port (port of ``repro.gnnserve``):

  cache     — HotEmbeddingCache: version-validated LRU over the
              embedding-server rows
  engine    — ShardServeEngine (deterministic expansion + early-exit
              forward for one shard); build_serving() assembles the
              multi-shard ServingPlane
  batcher   — QueryBatcher: continuous batching into fixed-size forwards
  wire      — PREDICT / SSTATS frames on the exchange framing, the JAX
              bytes under ``PT_OP_*`` names
  frontend  — threaded TCP scoring frontend + GnnServeClient

CLI: ``python -m repro_torch.launch.gnn_serve``.
"""

from .batcher import QueryBatcher, ServedResult
from .cache import HotEmbeddingCache
from .engine import ServingPlane, ShardServeEngine, build_serving
from .frontend import GnnServeClient, GnnServeHandle, serve_in_thread

__all__ = ["QueryBatcher", "ServedResult", "HotEmbeddingCache",
           "ServingPlane", "ShardServeEngine", "build_serving",
           "GnnServeClient", "GnnServeHandle", "serve_in_thread"]
