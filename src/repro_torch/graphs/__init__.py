"""Graph substrate of the port: CSR graphs, synthetic presets, partitions
and client shards (numpy, copied from ``repro.graphs``)."""

from .graph import Graph, from_edges
from .partition import (ClientShard, assemble_shard, bfs_partition,
                        make_client_shards)
from .sampler import Block
from .synthetic import PRESETS, make_graph

__all__ = ["Graph", "from_edges", "ClientShard", "assemble_shard",
           "bfs_partition", "make_client_shards", "Block", "PRESETS",
           "make_graph"]
