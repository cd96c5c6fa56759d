"""Per-shard serving engine: deterministic expansion + early exit.

Port of ``repro/gnnserve/engine.py``.  Serving answers "classify vertex
v" against the state training published: the model, the shard graphs,
and the embedding server holding every vertex's h^1..h^{L-1}
(:func:`repro_torch.core.federated.export_for_serving`).

Neighbourhood expansion is deterministic: each vertex contributes its
first ``serve_fanout`` CSR in-neighbours, so a query's answer is a pure
function of (model, graph, store state).  Early exit: a depth-``d`` pass
expands only ``d`` hops, seeds the deepest frontier with the *stored*
h^{L-d} rows pulled through the hot-embedding cache, and runs the top
``d`` GNN layers; a request retires when its softmax confidence is
strictly above its threshold, else it escalates.  The final depth is the
full ``L``-hop pass over raw features, so a threshold of 1.0 reproduces
the offline forward.

Remote destination rows at intermediate layers come from per-layer slot
tables on the device, refreshed from the cache only where a row's
server version moved.  Forwards run under ``torch.inference_mode()``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.graphs.sampler import Block, _pad_to, _round_up
from repro_torch.models.gnn import GNN, block_arrays
from repro_torch.obsv.metrics import REGISTRY

from .cache import HotEmbeddingCache

_FORWARDS = REGISTRY.counter("pt_gnnserve.forwards")


class ShardServeEngine:
    """Query answering for the local vertices of one ClientShard."""

    def __init__(self, model: GNN, shard, *, cache: HotEmbeddingCache,
                 serve_fanout: int = 10, batch_size: int = 64,
                 depth_schedule: list[int] | None = None,
                 device: str = "cuda"):
        self.model = model
        self.shard = shard
        self.cache = cache
        self.fanout = serve_fanout
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.L = model.num_layers
        if depth_schedule is None:
            depth_schedule = list(range(1, self.L + 1))
        if not (depth_schedule == sorted(set(depth_schedule))
                and depth_schedule[-1] == self.L
                and all(1 <= d <= self.L for d in depth_schedule)):
            raise ValueError("depth_schedule must be ascending and end at "
                             f"L={self.L}: {depth_schedule}")
        self.depth_schedule = depth_schedule

        n_total = len(shard.global_ids)
        # static pads per hop, the training sampler's
        self._p_nodes = [
            _round_up(min(batch_size * (serve_fanout + 1) ** h, n_total))
            for h in range(self.L + 1)
        ]
        self._p_edges = [
            _round_up(min(batch_size * (serve_fanout + 1) ** h, n_total)
                      * serve_fanout)
            for h in range(self.L)
        ]
        # a copy: a prebuilt shard's arrays are read-only file views
        self.features = torch.from_numpy(
            np.array(shard.features, np.float32)).to(self.device)
        self.hidden = model.hidden if self.L > 1 \
            else int(shard.features.shape[1])
        # remote-slot tables: slot i ↔ shard.pull_nodes[i]; _slot_ver
        # mirrors the cache versions so a forward only re-writes rows a
        # push actually invalidated
        p_rem = max(1, shard.num_remote)
        self._ctbl = [torch.zeros((p_rem, self.hidden), dtype=torch.float32,
                                  device=self.device)
                      for _ in range(self.L - 1)]
        self._slot_ver = [np.full(p_rem, -1, np.int64)
                          for _ in range(self.L - 1)]
        local = np.asarray(shard.global_ids[: shard.num_local], np.int64)
        self._g2l = {int(g): i for i, g in enumerate(local)}
        # telemetry
        self.forwards = 0
        self.rows_in = 0          # store rows requested for input tables

    # -- planning (deterministic sampler) -----------------------------------

    def local_id(self, vid: int) -> int:
        """Global vertex id → shard-local id; KeyError if not owned."""
        return self._g2l[int(vid)]

    def _neighbors(self, frontier: np.ndarray, *, local_only: bool):
        """First-``fanout`` CSR in-neighbours of each LOCAL frontier
        node (deterministic truncation; remote nodes terminate)."""
        sh = self.shard
        srcs, dsts = [], []
        for u in frontier:
            if u >= sh.num_local:
                continue
            nbrs = sh.indices[sh.indptr[u]: sh.indptr[u + 1]]
            if local_only:
                nbrs = nbrs[nbrs < sh.num_local]
            nbrs = nbrs[: self.fanout]
            if len(nbrs) == 0:
                continue
            srcs.append(nbrs.astype(np.int64))
            dsts.append(np.full(len(nbrs), u, dtype=np.int64))
        if not srcs:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(srcs), np.concatenate(dsts)

    def _plan(self, seeds: np.ndarray, depth: int) -> dict:
        """Expand ``depth`` hops and build the padded blocks for GNN
        layers ``L-depth+1 .. L`` (dst-prefix layout of the training
        sampler; the hop pads are shared across depths)."""
        sh, L, d = self.shard, self.L, depth
        if len(seeds) > self.batch_size:
            raise ValueError(f"{len(seeds)} seeds exceed the batch of "
                             f"{self.batch_size}")
        layers = [np.asarray(seeds, np.int64)]
        layer_edges = []
        for hop in range(1, d + 1):
            cur = layers[-1]
            # rule 3 applies only to the full-depth pass: its input is
            # raw h^0 features, unavailable for remote vertices.  A
            # shallower pass seeds from *stored* h^{L-d}, which the
            # server has for every vertex.
            e_src, e_dst = self._neighbors(
                cur, local_only=(d == L and hop == L))
            new = np.setdiff1d(np.unique(e_src), cur)
            layers.append(np.concatenate([cur, new]))
            layer_edges.append((e_src, e_dst))

        blocks, remote_used = [], {}
        for j in range(1, d + 1):            # j-th applied block
            l = L - d + j                    # absolute GNN layer
            src_nodes = layers[d - j + 1]
            dst_nodes = layers[d - j]
            e_src, e_dst = layer_edges[d - j]
            pos = {int(u): i for i, u in enumerate(src_nodes)}
            es = np.fromiter((pos[int(u)] for u in e_src), np.int64,
                             len(e_src))
            ed = np.fromiter((pos[int(u)] for u in e_dst), np.int64,
                             len(e_dst))
            p_src = self._p_nodes[d - j + 1]
            p_dst = self._p_nodes[d - j]
            p_e = self._p_edges[d - j]
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
                dst_mask=_pad_to(np.ones(len(dst_nodes), bool), p_dst, False),
            ))
            if l < L:
                remote_used[l] = np.unique(slot[remote]).astype(np.int64)
        return {"blocks": blocks, "input_nodes": layers[d],
                "remote_used": remote_used, "n_seeds": len(seeds)}

    # -- cache-backed tables -------------------------------------------------

    def _refresh_slots(self, layer: int, slots: np.ndarray) -> None:
        """Revalidate the remote-slot table rows a batch will read; only
        rows whose server version moved are re-written."""
        if len(slots) == 0:
            return
        gids = self.shard.pull_nodes[slots]
        rows, ver = self.cache.get(gids, layer)
        changed = self._slot_ver[layer - 1][slots] != ver
        if np.any(changed):
            idx = slots[changed]
            self._ctbl[layer - 1][torch.from_numpy(idx).to(self.device)] = \
                torch.from_numpy(rows[changed]).to(self.device)
            self._slot_ver[layer - 1][idx] = ver[changed]

    def _batch_arrays(self, plan: dict) -> dict:
        return block_arrays(plan["blocks"], plan["blocks"][0].src_ids,
                            self.device)

    # -- forward -------------------------------------------------------------

    def forward_depth(self, seeds: np.ndarray, depth: int) -> np.ndarray:
        """Logits for shard-local ``seeds``, one row per seed, computed on
        the sorted unique seed set (a duplicated seed would lose its
        edges in the block's position maps)."""
        seeds = np.asarray(seeds, np.int64)
        uniq, inv = np.unique(seeds, return_inverse=True)
        return self._forward_unique(uniq, depth)[: len(uniq)][inv]

    @torch.inference_mode()
    def _forward_unique(self, seeds: np.ndarray, depth: int) -> np.ndarray:
        L, d = self.L, depth
        plan = self._plan(seeds, d)
        for l, slots in plan["remote_used"].items():
            self._refresh_slots(l, slots)
        batch = self._batch_arrays(plan)
        self.forwards += 1
        _FORWARDS.inc()
        if d == L:
            logits = self.model(batch, self.features, self._ctbl)
        else:
            start = L - d + 1
            inp = plan["input_nodes"]
            gids = self.shard.global_ids[inp]
            rows, _ = self.cache.get(gids, L - d)
            self.rows_in += len(gids)
            h_in = torch.zeros((self._p_nodes[d], self.hidden),
                               dtype=torch.float32, device=self.device)
            h_in[: len(inp)] = torch.from_numpy(rows).to(self.device)
            caches = [self._ctbl[l - 1] for l in range(start, L)]
            logits = self.model.forward_from(start, h_in, batch["blocks"],
                                             caches)
        return logits.cpu().numpy()

    def predict_at_depth(self, seeds: np.ndarray, thresholds: np.ndarray,
                         depth: int
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One depth pass over a batch: a request retires when its
        max-softmax confidence is *strictly* above its threshold or at
        full depth.  Returns (preds int32, confidences float32, exit
        depths int32) where -1 marks a request that must escalate."""
        seeds = np.asarray(seeds, np.int64)
        thr = np.asarray(thresholds, np.float32)
        logits = self.forward_depth(seeds, depth)[: len(seeds)]
        z = logits - logits.max(axis=-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=-1, keepdims=True)
        pred = np.argmax(logits, axis=-1).astype(np.int32)
        conf = p.max(axis=-1).astype(np.float32)
        retire = (conf > thr) | (depth == self.L)
        return pred, conf, np.where(retire, depth, -1).astype(np.int32)

    def predict(self, seeds: np.ndarray, thresholds: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Depth-escalating batch prediction over the whole schedule.
        Returns (preds, confidences, exit depths), aligned with seeds."""
        seeds = np.asarray(seeds, np.int64)
        thr = np.asarray(thresholds, np.float32)
        n = len(seeds)
        preds = np.zeros(n, np.int32)
        confs = np.zeros(n, np.float32)
        depths = np.zeros(n, np.int32)
        active = np.arange(n)
        for d in self.depth_schedule:
            if len(active) == 0:
                break
            pred, conf, dd = self.predict_at_depth(seeds[active],
                                                   thr[active], d)
            retire = dd >= 0
            done = active[retire]
            preds[done] = pred[retire]
            confs[done] = conf[retire]
            depths[done] = d
            active = active[~retire]
        return preds, confs, depths

    @torch.inference_mode()
    def offline_predict(self, seeds: np.ndarray) -> np.ndarray:
        """Reference: a direct full-depth forward on the same
        deterministic neighbourhoods — no cache, no batcher, no early
        exit; remote rows are peeked from the store."""
        L = self.L
        seeds = np.asarray(seeds, np.int64)
        uniq, inv = np.unique(seeds, return_inverse=True)
        plan = self._plan(uniq, L)
        caches = []
        for l in range(1, L):
            slots = plan["remote_used"].get(l, np.zeros(0, np.int64))
            tbl = torch.zeros((max(1, self.shard.num_remote), self.hidden),
                              dtype=torch.float32, device=self.device)
            if len(slots):
                vals = self.cache.ex.peek(self.shard.pull_nodes[slots], [l])
                tbl[torch.from_numpy(slots).to(self.device)] = vals[0]
            caches.append(tbl)
        batch = self._batch_arrays(plan)
        logits = self.model(batch, self.features, caches)
        return np.argmax(logits.cpu().numpy()[: len(uniq)][inv],
                         axis=-1).astype(np.int32)


class ServingPlane:
    """Multi-shard serving: routes a query to its owner shard's engine
    and batcher, one shared hot-embedding cache across engines."""

    def __init__(self, engines: dict, batchers: dict, part: np.ndarray,
                 cache: HotEmbeddingCache):
        self.engines = engines
        self.batchers = batchers
        self.part = part
        self.cache = cache
        self._next_rid = 0

    def submit(self, vid: int, threshold: float = 1.0) -> int:
        owner = int(self.part[int(vid)])
        if owner not in self.batchers:
            raise KeyError(f"vertex {vid} lives on client {owner}, which "
                           "this serving plane does not host")
        rid = self._next_rid
        self._next_rid += 1
        self.batchers[owner].submit(vid, threshold, rid=rid)
        return rid

    def pending(self) -> int:
        return sum(b.pending() for b in self.batchers.values())

    def step(self) -> list:
        """One forward per non-idle shard batcher; returns newly
        completed results, popped from the batchers' ``completed``
        records so a long-running plane (the TCP frontend) keeps no
        result it has returned."""
        out = []
        for b in self.batchers.values():
            if b.pending():
                b.step()
            out.extend(b.pop_completed())
        return out

    def drain(self) -> list:
        out = []
        while self.pending():
            out.extend(self.step())
        return out

    def stats(self) -> dict:
        per_depth: dict[int, int] = {}
        served = 0
        for b in self.batchers.values():
            served += b.served
            for d, c in b.exits_by_depth.items():
                per_depth[d] = per_depth.get(d, 0) + c
        return {
            "served": served,
            "exits_by_depth": {str(k): v
                               for k, v in sorted(per_depth.items())},
            "forwards": sum(e.forwards for e in self.engines.values()),
            "cache": self.cache.stats(),
            "cache_hit_rate": self.cache.hit_rate,
        }


def build_serving(bundle: dict, *, cache_rows: int = 100_000,
                  serve_fanout: int = 10, batch_size: int = 64,
                  depth_schedule: list[int] | None = None,
                  device: str = "cuda") -> ServingPlane:
    """Assemble a ServingPlane from an ``export_for_serving`` bundle
    (model + shards + the live embedding exchange)."""
    from repro_torch.exchange import ExchangeClient

    from .batcher import QueryBatcher
    ex = ExchangeClient(bundle["transport"], bundle["codec"])
    cache = HotEmbeddingCache(ex, capacity_rows=cache_rows)
    engines, batchers = {}, {}
    for ci, shard in bundle["shards"].items():
        eng = ShardServeEngine(
            bundle["model"], shard, cache=cache, serve_fanout=serve_fanout,
            batch_size=batch_size, depth_schedule=depth_schedule,
            device=device)
        engines[ci] = eng
        batchers[ci] = QueryBatcher(eng)
    return ServingPlane(engines, batchers, bundle["part"], cache)
