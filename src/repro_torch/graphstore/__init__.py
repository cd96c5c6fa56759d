"""Out-of-core graph plane: mmap CSR stores, streaming builders and
generators, and single-pass streaming partitioning — interchangeable
with the in-memory ``repro_torch.graphs`` substrate (same accessor
protocol, bit-identical outputs at any scale that fits both planes).

Port of ``repro/graphstore``: numpy only, no torch, and the same files
byte for byte, so a store either package built opens in the other."""

from .builder import build_csr_store, chunked
from .generators import build_rmat_store, build_sbm_store, rmat_chunks
from .partition_stream import (build_client_shards, ldg_partition,
                               stream_client_shards)
from .store import GraphStore, open_store, store_from_graph

__all__ = [
    "GraphStore", "open_store", "store_from_graph",
    "build_csr_store", "chunked",
    "build_rmat_store", "build_sbm_store", "rmat_chunks",
    "ldg_partition", "stream_client_shards", "build_client_shards",
]
