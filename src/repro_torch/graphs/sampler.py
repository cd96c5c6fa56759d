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
the client's embedding cache.  Sampling runs on the host: each hop's
neighbour draw is one compiled pass (``csrc/neighbor_draw.cpp``) that
draws from the sampler's own numpy generator exactly as a per-vertex
``rng.choice(nbrs, size=fanout, replace=False)`` loop would, and hands
back to ``rng.choice`` the vertices that take numpy's tail-shuffle
branch; :data:`DRAWS` counts both.  The first sampler of a fanout in a
process checks the pass against ``rng.choice`` on a probe and raises if
they differ.

Each minibatch records the port's spans ``sampler.batch`` (the whole of
:meth:`NeighborSampler.sample_batch`) and ``sampler.draw`` (its hop
loop) in the fine ring of :data:`repro_torch.obsv.trace.TRACE`; the JAX
sampler records none.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.kernels import _host
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


#: Vertices whose neighbours were drawn: by the compiled pass, and by
#: ``rng.choice`` where the pass hands a vertex back (numpy's tail shuffle).
DRAWS: dict[str, int] = {"compiled": 0, "fallback": 0}


class _DrawArgs(ctypes.Structure):
    """The argument struct of ``neighbor_draw`` (``csrc/neighbor_draw.cpp``)."""

    _fields_ = [("frontier", ctypes.c_void_p), ("n_frontier", ctypes.c_int64),
                ("start", ctypes.c_int64), ("indptr", ctypes.c_void_p),
                ("indices", ctypes.c_void_p), ("num_local", ctypes.c_int64),
                ("fanout", ctypes.c_int64), ("local_only", ctypes.c_int64),
                ("out_src", ctypes.c_void_p), ("out_dst", ctypes.c_void_p),
                ("n_written", ctypes.c_int64), ("n_drawn", ctypes.c_int64),
                ("stop", ctypes.c_int64), ("state", ctypes.c_void_p),
                ("next_uint32", ctypes.c_void_p)]


_entry = None


def _run_pass(args: _DrawArgs) -> int:
    """One call of the compiled pass; the count of edges written."""
    global _entry
    if _entry is None:
        fn = _host.library("neighbor_draw").neighbor_draw
        fn.argtypes = [ctypes.POINTER(_DrawArgs)]
        fn.restype = ctypes.c_int64
        _entry = fn
    return _entry(ctypes.byref(args))


def draw_neighbors(frontier: np.ndarray, indptr: np.ndarray,
                   indices: np.ndarray, num_local: int, fanout: int,
                   local_only: bool, rng: np.random.Generator):
    """Sample ≤fanout in-neighbours for each LOCAL node in frontier, as
    ``rng.choice(nbrs, size=fanout, replace=False)`` a vertex would.

    ``indptr`` is contiguous int64 and ``indices`` contiguous int32.
    Returns (edge_src_ids, edge_dst_ids) in shard-local node ids.  Remote
    frontier nodes are skipped (rule 2)."""
    if not (indptr.dtype == np.int64 and indices.dtype == np.int32
            and indptr.flags.c_contiguous and indices.flags.c_contiguous
            and len(indptr) > num_local
            and indptr[num_local] <= len(indices)):
        raise ValueError("draw_neighbors takes a contiguous int64 indptr "
                         "over num_local vertices and contiguous int32 "
                         "indices")
    frontier = np.ascontiguousarray(frontier, dtype=np.int64)
    n = len(frontier)
    src = np.empty(n * fanout, np.int64)
    dst = np.empty(n * fanout, np.int64)
    bits = rng.bit_generator.ctypes
    args = _DrawArgs(
        frontier.ctypes.data, n, 0, indptr.ctypes.data, indices.ctypes.data,
        num_local, fanout, local_only, src.ctypes.data, dst.ctypes.data, 0, 0,
        0, bits.state_address,
        ctypes.cast(bits.next_uint32, ctypes.c_void_p).value)
    while True:
        args.n_written = _run_pass(args)
        DRAWS["compiled"] += args.n_drawn
        if args.stop == n:
            return src[: args.n_written], dst[: args.n_written]
        # numpy's tail-shuffle branch, which the pass does not replay
        u = int(frontier[args.stop])
        nbrs = indices[indptr[u]: indptr[u + 1]]
        if local_only:
            nbrs = nbrs[nbrs < num_local]
        k = args.n_written
        src[k: k + fanout] = rng.choice(nbrs, size=fanout, replace=False)
        dst[k: k + fanout] = u
        args.n_written = k + fanout
        args.start = args.stop + 1
        DRAWS["fallback"] += 1


def _choice_loop(frontier, indptr, indices, num_local, fanout, local_only,
                 rng):
    """What :func:`draw_neighbors` replays: one ``rng.choice`` a vertex."""
    srcs, dsts = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for u in frontier:
        if u >= num_local:
            continue
        nbrs = indices[indptr[u]: indptr[u + 1]]
        if local_only:
            nbrs = nbrs[nbrs < num_local]
        if len(nbrs) > fanout:
            nbrs = rng.choice(nbrs, size=fanout, replace=False)
        srcs.append(nbrs.astype(np.int64))
        dsts.append(np.full(len(nbrs), u, dtype=np.int64))
    return np.concatenate(srcs), np.concatenate(dsts)


#: Fanouts whose compiled pass matched ``rng.choice`` in this process.
_checked: set[int] = set()


def check_draw(fanout: int) -> None:
    """Draw a probe (degrees around ``fanout``, remote frontier vertices
    and neighbours, both hop kinds) through the compiled pass and through
    ``rng.choice``; raise unless picks and generator state agree.  A numpy
    whose ``Generator.choice`` draws otherwise fails here, instead of
    drifting from samplers that call ``rng.choice``."""
    if fanout in _checked:
        return
    degrees = [0, 1, fanout, fanout + 1, fanout + 2, 2 * fanout + 3,
               40 * fanout + 7]
    num_local = len(degrees)
    indptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int64)
    probe = np.random.default_rng(20_240_613)
    indices = probe.integers(0, 2 * num_local, indptr[-1]).astype(np.int32)
    frontier = np.concatenate([np.arange(num_local), [num_local]] * 3)
    for local_only in (False, True):
        a, b = np.random.default_rng(7), np.random.default_rng(7)
        got = draw_neighbors(frontier, indptr, indices, num_local, fanout,
                             local_only, a)
        want = _choice_loop(frontier, indptr, indices, num_local, fanout,
                            local_only, b)
        if not (all(np.array_equal(g, w) for g, w in zip(got, want))
                and a.bit_generator.state == b.bit_generator.state):
            raise RuntimeError(
                f"the compiled neighbour draw no longer replays numpy "
                f"{np.__version__}'s Generator.choice (fanout {fanout}, "
                f"local_only {local_only})")
    _checked.add(fanout)


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
        self._indptr = np.ascontiguousarray(shard.indptr, dtype=np.int64)
        self._indices = np.ascontiguousarray(shard.indices, dtype=np.int32)
        # shard-local id -> position in a block's source nodes; and the
        # ids of a hop's frontier, marked while the hop grows it
        self._slot = np.zeros(n_total, np.int64)
        self._seen = np.zeros(n_total, bool)
        check_draw(fanout)

    # -- sampling --------------------------------------------------------

    def _sample_neighbors(self, frontier: np.ndarray, local_only: bool):
        """Sample ≤fanout in-neighbours for each LOCAL node in frontier
        (:func:`draw_neighbors` over the shard)."""
        return draw_neighbors(frontier, self._indptr, self._indices,
                              self.shard.num_local, self.fanout, local_only,
                              self.rng)

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
                    # np.setdiff1d(np.unique(e_src), cur), by a table
                    ids = np.unique(e_src)
                    self._seen[cur] = True
                    new = ids[~self._seen[ids]]
                    self._seen[cur] = False
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
                # every endpoint is in src_nodes (e_dst in its dst prefix),
                # so no entry is read that this layer did not write
                self._slot[src_nodes] = np.arange(len(src_nodes))
                es = self._slot[e_src]
                ed = self._slot[e_dst]
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
