"""Padded bipartite blocks shared by the GNN layers and the serving
engine (the block types of ``repro/graphs/sampler.py``; the random
``NeighborSampler`` comes with the training slice).

A block's destination nodes are a prefix of its source nodes.  Blocks
are padded to static sizes; remote destination rows are not computed by
the GNN layer but read from the embedding cache.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Block:
    """One bipartite sampling layer.  dst nodes are a prefix of src nodes."""

    src_ids: np.ndarray          # (P_src,) shard-local node ids (padded w/ 0)
    n_src: int
    n_dst: int
    edge_src: np.ndarray         # (P_e,) indices into src_ids
    edge_dst: np.ndarray         # (P_e,) indices into [0, n_dst)
    edge_mask: np.ndarray        # (P_e,) bool
    dst_remote_mask: np.ndarray  # (P_dst,) bool — dst rows served from cache
    dst_remote_slot: np.ndarray  # (P_dst,) int32 — row in the remote cache
    dst_mask: np.ndarray         # (P_dst,) bool

    @property
    def p_src(self) -> int:
        return int(self.src_ids.shape[0])

    @property
    def p_dst(self) -> int:
        return int(self.dst_remote_mask.shape[0])


def _pad_to(x: np.ndarray, n: int, fill=0) -> np.ndarray:
    out = np.full((n,) + x.shape[1:], fill, dtype=x.dtype)
    out[: len(x)] = x
    return out


def _round_up(n: int, m: int = 128) -> int:
    return max(m, ((n + m - 1) // m) * m)
