"""Seeded, reproducible graph-growth schedules.

Port of ``repro/dyngraph/events.py`` (numpy only): the same batches,
node rows and stores, byte for byte.

A schedule carves one RMAT stream (``repro_torch.graphstore.rmat_chunks``)
into a base graph plus ``num_events`` growth batches by *vertex
frontier*: event ``e`` admits every edge whose larger endpoint falls in
``[frontier(e-1), frontier(e))``.  Because an edge's epoch depends only
on its endpoints, the split is independent of chunking and of how many
events have already been applied — any process replaying the same
``(scale, edge_factor, seed, schedule)`` tuple sees byte-identical
batches, which is what lets multi-process fed workers grow their local
views independently yet stay in lockstep.

Node data is generated per fixed-size vertex block from a child-seeded
rng (``(seed, 0x5EED, block)``), so the arrays for vertex ``v`` never
depend on how far the frontier has advanced — the rows an event
introduces are the same rows a from-scratch build of the full graph
would hold, making compaction bit-identity possible at all.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphstore.builder import build_csr_store
from repro_torch.graphstore.generators import rmat_chunks

NODE_BLOCK = 1 << 12


@dataclasses.dataclass(frozen=True)
class GrowthSchedule:
    """Everything a growth run depends on — JSON-safe by design."""

    scale: int                      # final graph has 2**scale vertices
    edge_factor: int = 8
    seed: int = 0
    base_frac: float = 0.5          # fraction of vertices in the base
    num_events: int = 4
    start_round: int = 1            # round before which event 1 lands
    every_rounds: int = 1           # rounds between events
    num_classes: int = 16
    feat_dim: int = 32
    train_frac: float = 0.01
    feature_noise: float = 2.0

    # -- geometry ----------------------------------------------------------

    @property
    def num_vertices(self) -> int:
        return 1 << self.scale

    @property
    def base_vertices(self) -> int:
        v0 = int(self.num_vertices * self.base_frac)
        return min(max(v0, self.num_classes), self.num_vertices)

    def frontier(self, epoch: int) -> int:
        """Vertex count after ``epoch`` events (0 = base)."""
        e = min(max(int(epoch), 0), self.num_events)
        v0, v = self.base_vertices, self.num_vertices
        return v0 + (v - v0) * e // self.num_events

    def epoch_for_round(self, round_idx: int) -> int:
        """Events due strictly before training round ``round_idx``."""
        if round_idx < self.start_round:
            return 0
        due = (round_idx - self.start_round) // self.every_rounds + 1
        return min(due, self.num_events)

    # -- edge streams ------------------------------------------------------

    def _band_chunks(self, lo: int, hi: int):
        """Edges whose larger endpoint lies in ``[lo, hi)``."""
        for src, dst in rmat_chunks(self.scale, self.edge_factor,
                                    self.seed):
            m = np.maximum(src, dst)
            keep = (m >= lo) & (m < hi)
            if np.any(keep):
                yield src[keep], dst[keep]

    def base_chunks(self):
        return self._band_chunks(0, self.base_vertices)

    def full_chunks(self):
        return self._band_chunks(0, self.num_vertices)

    def event_edges(self, epoch: int) -> tuple[np.ndarray, np.ndarray]:
        """All edges of event ``epoch`` (1-based), concatenated."""
        lo, hi = self.frontier(epoch - 1), self.frontier(epoch)
        srcs, dsts = [], []
        for s, d in self._band_chunks(lo, hi):
            srcs.append(s)
            dsts.append(d)
        if not srcs:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return (np.concatenate(srcs).astype(np.int64),
                np.concatenate(dsts).astype(np.int64))

    # -- node data ---------------------------------------------------------

    def _proj(self) -> np.ndarray:
        rng = np.random.default_rng((self.seed, 0x5EED))
        return rng.standard_normal(
            (self.num_classes, self.feat_dim)).astype(np.float32)

    def node_rows(self, lo: int, hi: int) -> dict:
        """Arrays for vertex rows ``[lo, hi)`` — identical no matter
        which frontier (or process) asks for them."""
        proj = self._proj()
        labels = np.zeros(hi - lo, np.int32)
        feats = np.zeros((hi - lo, self.feat_dim), np.float32)
        mask = np.zeros(hi - lo, bool)
        b = lo // NODE_BLOCK
        while b * NODE_BLOCK < hi:
            rng = np.random.default_rng((self.seed, 0x5EED, b))
            lab_b = rng.integers(0, self.num_classes,
                                 NODE_BLOCK).astype(np.int32)
            noise = rng.standard_normal(
                (NODE_BLOCK, self.feat_dim)).astype(np.float32)
            mask_b = rng.random(NODE_BLOCK) < self.train_frac
            s = max(lo, b * NODE_BLOCK)
            e = min(hi, (b + 1) * NODE_BLOCK)
            off = b * NODE_BLOCK
            labels[s - lo:e - lo] = lab_b[s - off:e - off]
            feats[s - lo:e - lo] = (proj[lab_b[s - off:e - off]]
                                    + self.feature_noise
                                    * noise[s - off:e - off])
            mask[s - lo:e - lo] = mask_b[s - off:e - off]
            b += 1
        # every class is seeded with at least one training vertex
        if lo < self.num_classes:
            mask[:self.num_classes - lo] = True
        return {"features": feats, "labels": labels, "train_mask": mask}

    def event_batch(self, epoch: int
                    ) -> tuple[np.ndarray, np.ndarray, dict]:
        src, dst = self.event_edges(epoch)
        return src, dst, self.node_rows(self.frontier(epoch - 1),
                                        self.frontier(epoch))

    # -- store builders ----------------------------------------------------

    def _node_writer(self, v: int):
        import os

        def write(path: str) -> dict:
            rows = self.node_rows(0, v)
            np.save(os.path.join(path, "features.npy"), rows["features"])
            np.save(os.path.join(path, "labels.npy"), rows["labels"])
            np.save(os.path.join(path, "train_mask.npy"),
                    rows["train_mask"])
            return {"num_classes": int(self.num_classes)}

        return write

    def build_base(self, path: str, *, name: str = "dyn_base"):
        """Materialize the epoch-0 store the overlay grows from."""
        v0 = self.base_vertices
        return build_csr_store(
            self.base_chunks(), v0, path, symmetric=True, dedup=True,
            est_pairs=max(1, self.num_vertices * self.edge_factor),
            node_writer=self._node_writer(v0), name=name)

    def build_full(self, path: str, *, name: str = "dyn_full"):
        """From-scratch build of the fully-grown graph — the reference
        the compaction bit-identity test compares against."""
        v = self.num_vertices
        return build_csr_store(
            self.full_chunks(), v, path, symmetric=True, dedup=True,
            est_pairs=max(1, self.num_vertices * self.edge_factor),
            node_writer=self._node_writer(v), name=name)

    # -- config plumbing ---------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "GrowthSchedule":
        return cls(**d)
