"""The reference's neighbourhood expansions (numpy).

:class:`Sampler` is a frozen copy of the sampling of
``repro_torch/graphs/sampler.py`` ``NeighborSampler``: the same shard and
seed replay the same numpy random stream, so it draws the minibatches
the program trains on.  Its rules are the paper's §3.2.2: seeds are
local training vertices, a remote vertex ends its path, and the last hop
takes local vertices only.  ``cut`` keeps an epoch's first minibatches,
as the benchmark's cut of the program's epochs does.

A minibatch is ``(layers, edges)``: ``layers[0]`` the seeds,
``layers[h]`` the vertices within ``h`` hops (a prefix of
``layers[h + 1]``), and ``edges[h]`` the (src, dst) shard ids of hop
``h + 1``.
"""

from __future__ import annotations

import numpy as np


def _grow(layers: list, e_src: np.ndarray) -> None:
    cur = layers[-1]
    layers.append(np.concatenate([cur, np.setdiff1d(np.unique(e_src), cur)]))


class Sampler:
    def __init__(self, shard: dict, fanout: int, num_layers: int,
                 batch_size: int, seed: int, cut: int):
        self.sh = shard
        self.fanout = fanout
        self.L = num_layers
        self.batch_size = batch_size
        self.cut = cut
        self.rng = np.random.default_rng(seed + 7919 * shard["cid"])
        self.train = np.nonzero(shard["train_mask"])[0].astype(np.int64)

    def _neighbours(self, frontier: np.ndarray, local_only: bool):
        sh = self.sh
        nl = sh["num_local"]
        srcs, dsts = [], []
        for u in frontier:
            if u >= nl:
                continue
            nbrs = sh["indices"][sh["indptr"][u]: sh["indptr"][u + 1]]
            if local_only:
                nbrs = nbrs[nbrs < nl]
            if len(nbrs) == 0:
                continue
            if len(nbrs) > self.fanout:
                nbrs = self.rng.choice(nbrs, size=self.fanout, replace=False)
            srcs.append(nbrs.astype(np.int64))
            dsts.append(np.full(len(nbrs), u, dtype=np.int64))
        if not srcs:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(srcs), np.concatenate(dsts)

    def batch(self, seeds: np.ndarray) -> tuple[list, list]:
        layers = [np.asarray(seeds, np.int64)]
        edges = []
        for hop in range(1, self.L + 1):
            e_src, e_dst = self._neighbours(layers[-1], hop == self.L)
            _grow(layers, e_src)
            edges.append((e_src, e_dst))
        return layers, edges

    def epoch(self) -> list:
        order = self.train.copy()
        self.rng.shuffle(order)
        starts = range(0, len(order), self.batch_size)
        return [self.batch(order[i: i + self.batch_size])
                for i in list(starts)[: self.cut]]
