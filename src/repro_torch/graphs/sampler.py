"""Mini-batch neighbourhood sampler with federated boundary rules (copy of
``repro/graphs/sampler.py``: the same shard and seed replay the same
numpy random stream and give byte-identical blocks).

Builds DGL-style bipartite *blocks* for an L-layer GNN, enforcing the
paper's §3.2.2 custom-sampler rules:

  (1) only LOCAL vertices are sampled at the root level;
  (2) a remote vertex sampled at hop l ≤ L-1 terminates its path (its
      neighbourhood lives on another client);
  (3) no remote vertices appear at the L-th hop (their h^0 features are
      unavailable at the embedding server for privacy).

A block's destination nodes are a prefix of its source nodes.  Blocks
are padded to static sizes (shared with the serving engine's planner);
remote destination rows are not computed by the GNN layer but read from
the client's embedding cache.  Sampling runs on the host in numpy.

Each minibatch records the port's spans ``sampler.batch`` (the whole of
:meth:`NeighborSampler.sample_batch`) and ``sampler.draw`` (its hop
loop) in the fine ring of :data:`repro_torch.obsv.trace.TRACE`; the JAX
sampler records none.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.obsv.trace import TRACE

from .partition import ClientShard


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


@dataclasses.dataclass
class MiniBatch:
    blocks: list[Block]          # blocks[0] consumes hop-L nodes (h^0 input)
    seeds: np.ndarray            # root training vertices (shard-local ids)
    seed_mask: np.ndarray        # (P_seed,) bool
    input_ids: np.ndarray        # == blocks[0].src_ids (hop-L nodes, all local)
    # remote cache rows touched at each layer l (1..L-1): used by the
    # dynamic-pull runtime (§4.3) and the cost model.
    remote_slots_used: list[np.ndarray]


def _pad_to(x: np.ndarray, n: int, fill=0) -> np.ndarray:
    out = np.full((n,) + x.shape[1:], fill, dtype=x.dtype)
    out[: len(x)] = x
    return out


def _round_up(n: int, m: int = 128) -> int:
    return max(m, ((n + m - 1) // m) * m)


class NeighborSampler:
    """Uniform fanout sampler over a :class:`ClientShard`."""

    def __init__(
        self,
        shard: ClientShard,
        fanout: int,
        num_layers: int,
        batch_size: int,
        *,
        seed: int = 0,
    ):
        self.shard = shard
        self.fanout = fanout
        self.L = num_layers
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed + 7919 * shard.client_id)
        n_total = len(shard.global_ids)
        # Static pads per hop: B*(f+1)^h capped by shard size.
        self._p_nodes = [
            _round_up(min(batch_size * (fanout + 1) ** h, n_total))
            for h in range(num_layers + 1)
        ]
        self._p_edges = [
            _round_up(min(batch_size * (fanout + 1) ** h, n_total) * fanout)
            for h in range(num_layers)
        ]
        self._train = shard.train_vertices()

    # -- sampling --------------------------------------------------------

    def _sample_neighbors(self, frontier: np.ndarray, local_only: bool):
        """Sample ≤fanout in-neighbours for each LOCAL node in frontier.

        Returns (edge_src_ids, edge_dst_ids) in shard-local node ids.
        Remote frontier nodes are skipped (rule 2)."""
        sh = self.shard
        srcs, dsts = [], []
        for u in frontier:
            if u >= sh.num_local:      # remote: path terminates
                continue
            nbrs = sh.indices[sh.indptr[u]: sh.indptr[u + 1]]
            if local_only:
                nbrs = nbrs[nbrs < sh.num_local]
            if len(nbrs) == 0:
                continue
            if len(nbrs) > self.fanout:
                nbrs = self.rng.choice(nbrs, size=self.fanout, replace=False)
            srcs.append(nbrs.astype(np.int64))
            dsts.append(np.full(len(nbrs), u, dtype=np.int64))
        if not srcs:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(srcs), np.concatenate(dsts)

    def sample_batch(self, seeds: np.ndarray) -> MiniBatch:
        # spans without args: no dict or span object per minibatch while
        # the recorder is off; the blocks' share is batch minus draw
        with TRACE.span("sampler.batch", fine=True):
            sh, L = self.shard, self.L
            layers: list[np.ndarray] = [np.asarray(seeds, dtype=np.int64)]
            layer_edges: list[tuple[np.ndarray, np.ndarray]] = []
            with TRACE.span("sampler.draw", fine=True):
                for hop in range(1, L + 1):
                    cur = layers[-1]
                    e_src, e_dst = self._sample_neighbors(
                        cur, local_only=(hop == L))
                    new = np.setdiff1d(np.unique(e_src), cur)
                    # dst-prefix ordering
                    layers.append(np.concatenate([cur, new]))
                    layer_edges.append((e_src, e_dst))

            blocks: list[Block] = []
            remote_used: list[np.ndarray] = []
            # GNN layer l (1-indexed) consumes node set layers[L-l+1],
            # produces layers[L-l]; edges are layer_edges[L-l].
            for l in range(1, L + 1):
                src_nodes = layers[L - l + 1]
                dst_nodes = layers[L - l]
                e_src, e_dst = layer_edges[L - l]
                pos = {int(u): i for i, u in enumerate(src_nodes)}
                es = np.fromiter((pos[int(u)] for u in e_src),
                                 dtype=np.int64, count=len(e_src))
                ed = np.fromiter((pos[int(u)] for u in e_dst),
                                 dtype=np.int64, count=len(e_dst))
                p_src = self._p_nodes[L - l + 1]
                p_dst = self._p_nodes[L - l]
                p_e = self._p_edges[L - l]
                remote = dst_nodes >= sh.num_local
                slot = np.where(remote, dst_nodes - sh.num_local, 0)
                blocks.append(Block(
                    src_ids=_pad_to(src_nodes, p_src),
                    n_src=len(src_nodes),
                    n_dst=len(dst_nodes),
                    edge_src=_pad_to(es, p_e),
                    edge_dst=_pad_to(ed, p_e),
                    edge_mask=_pad_to(np.ones(len(es), bool), p_e, False),
                    dst_remote_mask=_pad_to(remote, p_dst, False),
                    dst_remote_slot=_pad_to(slot.astype(np.int32), p_dst),
                    dst_mask=_pad_to(np.ones(len(dst_nodes), bool), p_dst,
                                     False),
                ))
                if l < L:   # layer l output = h^l; remote rows read cache[l]
                    remote_used.append(
                        np.unique(slot[remote]).astype(np.int64))

            p_seed = self._p_nodes[0]
            # Rule 3: h^0 (features) are never aggregated for remote
            # vertices — the first block's edge sources must all be local.
            # (The cumulative src node set MAY contain remote nodes from
            # earlier hops; their feature rows are never read as edge
            # sources and their outputs are overwritten from the embedding
            # cache.)
            b0 = blocks[0]
            src_of_edges = b0.src_ids[b0.edge_src[b0.edge_mask]]
            assert np.all(src_of_edges < sh.num_local)
            return MiniBatch(
                blocks=blocks,
                seeds=_pad_to(layers[0], p_seed),
                seed_mask=_pad_to(np.ones(len(layers[0]), bool), p_seed,
                                  False),
                input_ids=blocks[0].src_ids,
                remote_slots_used=remote_used,
            )

    def epoch(self, *, shuffle: bool = True) -> Iterator[MiniBatch]:
        order = self._train.copy()
        if shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order), self.batch_size):
            yield self.sample_batch(order[i: i + self.batch_size])

    def num_batches(self) -> int:
        return (len(self._train) + self.batch_size - 1) // self.batch_size
