"""Graph substrate of the port: CSR graphs, synthetic presets, partitions,
client shards and the neighbour sampler (numpy, copied from
``repro.graphs``)."""

from .graph import Graph, from_edges, induced_subgraph
from .partition import (ClientShard, assemble_shard, bfs_partition,
                        edge_cut, filter_shard_remote, hash_partition,
                        make_client_shards)
from .sampler import Block, MiniBatch, NeighborSampler
from .synthetic import PRESETS, make_graph

__all__ = ["Graph", "from_edges", "induced_subgraph", "ClientShard",
           "assemble_shard", "bfs_partition", "edge_cut", "filter_shard_remote",
           "hash_partition", "make_client_shards", "Block", "MiniBatch",
           "NeighborSampler", "PRESETS", "make_graph"]
