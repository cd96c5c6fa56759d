"""Federated GNN training runtime (paper §3) with OptimES strategies (§4).

Port of ``repro/core/federated.py``.  One process simulates the
cross-silo deployment: K client shards train in (logical) parallel on one
device; the aggregation server FedAvg-aggregates; the remote-embedding
exchange (codec × delta pushes, in-process transport with its tables on
the device) mediates every pull / push / prefetch / dynamic pull.
Compute is measured (host clock around work that ends in a device
synchronise); network is modelled by :class:`NetworkModel`.

The publish half is also usable without a trainer, as functions over
(model, shards, part, transport, codec):

  setup_exchange      — reciprocal push sets and registration of every
                        client's pull and push vertices
  pretrain_push       — §3.2.1 bootstrap: h^1..h^{L-1} of the push
                        vertices from the unexpanded local subgraph
  export_for_serving  — publish every owned vertex's h^1..h^{L-1} and
                        return the bundle ``gnnserve.build_serving`` takes

:class:`FederatedGNNTrainer` runs one embedding server or S hashed
shards (``num_server_shards``, with ``shard_placement="pull_frequency"``
re-placing rows by observed pulls at ``rebalance_round``), each shard
behind its own modelled link (``shard_nets``), or live TCP embedding
servers (``transport="tcp"`` with ``transport_addrs``).  With
``only_clients`` it is a shard-local trainer for a fedsvc worker: it
builds samplers, device arrays and registrations for those clients only
and never evaluates.  Its graph is an in-memory ``Graph`` or an mmap
:class:`repro_torch.graphstore.GraphStore` (partitioned by streaming LDG
when no ``part`` is given, its shards streamed), and ``shards=`` takes
prebuilt shards, e.g. a store's mmap'd shard files, so a worker never
re-scans the graph.  With ``growth=`` (a
:class:`repro_torch.dyngraph.GrowthRuntime`) the graph grows between
rounds: :meth:`FederatedGNNTrainer.apply_growth` swaps in the merged
overlay and rebuilds every shard-derived structure, keeping the model,
the exchange and its clients.  The coordinator's
fields of a Strategy (``aggregation``, ``weight_codec``,
``sample_frac``) are not read here, as in the JAX package: the fedsvc
coordinator and workers (:mod:`repro_torch.fedsvc`) read them.  It
records the JAX trainer's trace spans (``client.pull``, ``client.train_epoch``,
``client.push_compute``, ``round.aggregate``) on
:data:`repro_torch.obsv.trace.TRACE`, and the port's own: ``step.copy``,
``step.forward``, ``step.backward`` and ``step.optim`` for each
minibatch inside ``client.train_epoch`` (in the recorder's fine ring), and ``client.push_apply``
around each push's apply.  ``client.pull``, ``client.push_compute`` and
``client.push_apply`` synchronise the device at both ends while
recording, so they hold their device work.  Its models are
:class:`repro_torch.models.gnn.GNN` modules; FedAvg runs over their
leaves in the JAX package's order, so either trainer can start from the
other's parameters.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.exchange import (ExchangeClient, ShardedTransport,
                                  Transport, make_transport)
from repro_torch.exchange.client import PushPlan
from repro_torch.fedsvc.aggregation import fedavg_leaves
from repro_torch.graphs.partition import (ClientShard, bfs_partition,
                                          filter_shard_remote)
from repro_torch.graphs.sampler import MiniBatch, NeighborSampler
from repro_torch.graphstore import build_client_shards, ldg_partition
from repro_torch.models.gnn import (GNN, blocks_to_arrays, init_gnn, loss_fn,
                                    propagate_arrays, shard_to_arrays)
from repro_torch.obsv.trace import TRACE
from repro_torch.optim import Optimizer, adam

from .cost_model import NetworkModel
from .pruning import score_remote_nodes, top_fraction
from .strategies import Strategy


# -- publish half -------------------------------------------------------------

def assign_push_sets(shards: list[ClientShard], part: np.ndarray) -> None:
    """Push sets follow the (retained) pull sets: client c pushes exactly
    the vertices other clients pull from it (§4.1.1)."""
    for sh in shards:
        wanted = [other.pull_nodes[part[other.pull_nodes] == sh.client_id]
                  for other in shards if other.client_id != sh.client_id]
        sh.push_nodes = np.unique(np.concatenate(wanted)) \
            if wanted else np.zeros(0, np.int64)


def setup_exchange(shards: list[ClientShard], part: np.ndarray,
                   transport: Transport) -> None:
    """Assign the push sets, then register every client's pull and push
    vertices with the exchange."""
    assign_push_sets(shards, part)
    for sh in shards:
        for gids in (sh.pull_nodes, sh.push_nodes):
            transport.register(gids)


def push_rows(shard: ClientShard) -> np.ndarray:
    """Shard-local row of each of the shard's push vertices."""
    local = np.asarray(shard.global_ids[: shard.num_local], np.int64)
    order = np.argsort(local, kind="stable")
    pos = np.searchsorted(local[order], shard.push_nodes)
    return order[pos].astype(np.int64)


def fill_cache(client: ExchangeClient, shard: ClientShard,
               num_layers: int) -> list[torch.Tensor]:
    """The shard's remote-slot tables (slot i ↔ ``pull_nodes[i]``) filled
    with the pulled h^1..h^{L-1} rows as seen after the wire; one zero
    row when the shard has no remote vertices."""
    dev = client.transport.device
    hidden = client.hidden
    if len(shard.pull_nodes) == 0:
        return [torch.zeros((1, hidden), dtype=torch.float32, device=dev)
                for _ in range(num_layers - 1)]
    vals = client.peek(shard.pull_nodes)
    return [v.contiguous() for v in vals]


def push_bootstrap(model: GNN, shard: ClientShard, arrays: dict,
                   client: ExchangeClient) -> None:
    """§3.2.1 for one shard: its push vertices' h^1..h^{L-1} from the
    unexpanded local subgraph (remote neighbours masked), pushed through
    ``client``."""
    if len(shard.push_nodes) == 0:
        return
    outs = model.full_propagate(arrays, None)
    rows = torch.from_numpy(push_rows(shard)).to(outs[0].device)
    client.push(shard.push_nodes,
                [outs[l][rows] for l in range(model.num_layers - 1)])


def pretrain_push(model: GNN, shards: list[ClientShard],
                  transport: Transport, codec: str, *,
                  device: str = "cuda") -> None:
    """§3.2.1: push-vertex embeddings from the unexpanded local subgraphs
    (remote neighbours masked) seed the server."""
    client = ExchangeClient(transport, codec)
    for sh in shards:
        if len(sh.push_nodes):
            push_bootstrap(model, sh, shard_to_arrays(sh, device), client)


def export_for_serving(model: GNN, shards: list[ClientShard],
                       part: np.ndarray, transport: Transport, codec: str,
                       *, device: str = "cuda") -> dict:
    """Publish the model's state for the serving plane.

    A query can land on any vertex, so every shard's local vertices are
    registered and their full h^1..h^{L-1} pushed through the codec
    (a full-neighbourhood propagate against the cache each client pulls
    first, in client order, as the JAX trainer does).  Rows cross the
    wire through a plain client: delta shadows and error-feedback
    residuals of a trainer are left untouched.  Returns the bundle
    :func:`repro_torch.gnnserve.build_serving` consumes."""
    pub = ExchangeClient(transport, codec)
    L = model.num_layers
    for sh in shards:
        caches = fill_cache(pub, sh, L)
        outs = model.full_propagate(shard_to_arrays(sh, device), caches)
        gids = np.asarray(sh.global_ids[: sh.num_local], np.int64)
        pub.register(gids)
        pub.push(gids, [outs[l] for l in range(L - 1)])
    return {
        "model": model,
        "conv": model.conv,
        "num_layers": L,
        "hidden": model.hidden,
        "part": np.asarray(part),
        "shards": {sh.client_id: sh for sh in shards},
        "transport": transport,
        "codec": codec,
    }


# -- round records ------------------------------------------------------------

@dataclasses.dataclass
class PhaseTimes:
    """One client's (or a round's, max over clients) phase seconds.

    Measured on the host clock: ``train`` (sampling and the local
    epochs, each epoch ending in a synchronise), ``push_compute`` (the
    push vertices' propagate, ending in a synchronise) and the wall part
    of ``agg`` (FedAvg and the evaluation).  Modelled by the network
    model: ``pull``, ``dynamic_pull``, ``push_transfer`` and the
    model-transfer term of ``agg``."""
    pull: float = 0.0
    train: float = 0.0
    dynamic_pull: float = 0.0   # §4.3 on-demand pulls
    push_compute: float = 0.0
    push_transfer: float = 0.0
    agg: float = 0.0

    def client_total(self, *, overlap: bool, interference: float,
                     epochs: int) -> float:
        """Wall time for one client's round under the §4.2 timeline."""
        push = self.push_compute + self.push_transfer
        train = self.train + self.dynamic_pull
        if overlap and epochs >= 2:
            last_epoch = train / epochs
            head = train - last_epoch
            return self.pull + head + max(last_epoch * interference, push)
        return self.pull + train + push


@dataclasses.dataclass
class ClientRoundResult:
    """One client's share of a federated round."""
    client_id: int
    params: GNN                              # locally trained model
    phases: PhaseTimes
    rpc_sizes: list[int]                     # dynamic-pull RPC sizes
    push_plan: Optional[PushPlan]            # priced, not yet applied
    weight: float                            # FedAvg weight (train verts)
    loss: float
    client_time: float                       # modelled §4.2 wall time


@dataclasses.dataclass
class RoundStats:
    round_idx: int
    accuracy: float
    round_time: float
    cum_time: float
    phases: PhaseTimes                       # max over clients per phase
    pull_rpc_sizes: list[int]                # nodes per dynamic-pull RPC
    embeddings_stored: int
    train_loss: float


def time_to_accuracy(stats: list[RoundStats], target: float,
                     *, smooth: int = 5) -> Optional[float]:
    """Cumulative time when the ``smooth``-round moving average accuracy
    first reaches ``target`` (paper §5.2 metric)."""
    accs = [s.accuracy for s in stats]
    for i in range(len(accs)):
        lo = max(0, i - smooth + 1)
        if np.mean(accs[lo: i + 1]) >= target:
            return stats[i].cum_time
    return None


def peak_accuracy(stats: list[RoundStats]) -> float:
    return max(s.accuracy for s in stats) if stats else 0.0


def sampled_eval_vertices(g, max_edges: int, seed: int) -> np.ndarray:
    """Seeded uniform vertex sample whose in-edge mass fits ``max_edges``
    (≥ 1 vertex, sorted ascending)."""
    deg = np.diff(np.asarray(g.indptr))
    rng = np.random.default_rng((seed, 104729))
    perm = rng.permutation(g.num_vertices)
    k = int(np.searchsorted(np.cumsum(deg[perm]), max_edges, side="right"))
    return np.sort(perm[: max(1, k)]).astype(np.int64)


def eval_arrays_for(g, sel: np.ndarray, device) -> dict:
    """``full_propagate`` inputs on ``device`` over the subgraph induced by
    the sorted vertex selection ``sel`` (edges with both endpoints
    selected, ids remapped to positions in ``sel``)."""
    indptr = np.asarray(g.indptr)
    starts = indptr[sel]
    counts = (indptr[sel + 1] - starts).astype(np.int64)
    total = int(counts.sum())
    offsets = np.zeros(len(sel) + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    pos = (np.arange(total, dtype=np.int64)
           - np.repeat(offsets[:-1], counts) + np.repeat(starts, counts))
    e_src = np.asarray(g.indices[pos], dtype=np.int64)
    loc = np.minimum(np.searchsorted(sel, e_src), len(sel) - 1)
    keep = sel[loc] == e_src
    # a row's kept edges start after the kept edges of the rows before it
    kept_indptr = np.searchsorted(np.flatnonzero(keep), offsets)
    return propagate_arrays(kept_indptr, loc[keep], len(sel), len(sel),
                            g.features[sel], device)


class FederatedGNNTrainer:
    def __init__(
        self,
        graph,
        num_clients: int,
        strategy: Strategy,
        *,
        conv: str = "graphconv",
        num_layers: int = 3,
        hidden: int = 32,
        fanout: int = 5,
        batch_size: int = 64,
        epochs_per_round: int = 3,
        lr: float = 1e-2,
        optimizer: Optimizer | None = None,
        net: NetworkModel | None = None,
        shard_nets: list[NetworkModel] | None = None,
        seed: int = 0,
        part: np.ndarray | None = None,
        eval_max_edges: int = 4_000_000,
        model: GNN | None = None,
        device: str = "cuda",
        transport_addrs: list | None = None,
        shards: list | None = None,
        only_clients: list[int] | None = None,
        growth=None,
    ):
        if model is not None and (model.conv != conv
                                  or model.num_layers != num_layers
                                  or model.hidden != hidden):
            raise ValueError(
                f"model is a {model.num_layers}-layer {model.conv} of width "
                f"{model.hidden}, the trainer a {num_layers}-layer {conv} "
                f"of width {hidden}")
        self.g = graph
        self.k = num_clients
        self.strategy = strategy
        self.conv = conv
        self.L = num_layers
        self.hidden = hidden
        self.fanout = fanout
        self.batch_size = batch_size
        self.epochs = epochs_per_round
        self.lr = lr
        self.opt = optimizer or adam(lr)
        self.net = net or NetworkModel()
        # heterogeneous per-shard links (ShardedTransport); default: the
        # trainer-wide NetworkModel replicated per shard
        self.shard_nets = shard_nets
        # live embed_server listeners, one per shard (Strategy.transport
        # = "tcp", or inferred when addresses are given)
        self.transport_addrs = transport_addrs
        # shard-local mode (fedsvc workers): samplers, device arrays and
        # exchange registrations for the owned clients only; with
        # prebuilt ``shards`` (a store's mmap'd shard files, None for a
        # client another process owns) the graph is never re-scanned
        self.only_clients = None if only_clients is None \
            else sorted(int(c) for c in only_clients)
        self._prebuilt_shards = shards
        self.seed = seed
        self.eval_max_edges = eval_max_edges
        self.device = torch.device(device)
        # dynamic graphs (a repro_torch.dyngraph.GrowthRuntime):
        # apply_growth() advances it between rounds and rebuilds every
        # shard-derived structure when the graph jumps
        self.growth = growth
        self._growth_round = 0        # round of the last graph jump
        self._growth_accs_base = 0    # pre-jump accuracies to ignore (τ)
        if part is None:
            # an mmap store is partitioned by single-pass streaming LDG,
            # not by the BFS grow over O(V) frontiers
            part = ldg_partition(graph, num_clients, seed=seed) \
                if getattr(graph, "is_store", False) \
                else bfs_partition(graph, num_clients, seed=seed)
        self.part = part
        self.model = model
        self._setup()

    # -- setup ----------------------------------------------------------------

    def _client_rng(self, ci: int, salt: int) -> np.random.Generator:
        """Per-(client, purpose) generator for the R25-style random
        subset draws, seeded independently of build order."""
        return np.random.default_rng((self.seed, salt, ci))

    def _build_shards(self, limit, retained_remote=None
                      ) -> list[ClientShard]:
        """Shard extraction by graph plane: streamed over an mmap store,
        materialised for an in-memory Graph; the same shards either way."""
        return build_client_shards(self.g, self.part, retention_limit=limit,
                                   retained_remote=retained_remote,
                                   seed=self.seed)

    def _setup(self) -> None:
        st = self.strategy
        self.owned = list(range(self.k)) if self.only_clients is None \
            else self.only_clients
        self._registered = np.zeros(0, np.int64)  # gids the exchange knows
        self._build_shard_state()
        if st.shard_placement not in ("hash", "pull_frequency"):
            raise ValueError(
                f"unknown shard_placement {st.shard_placement!r}; "
                "expected hash | pull_frequency")
        if st.use_embeddings:
            self.exchange = make_transport(
                self.L, self.hidden, kind=st.transport,
                num_shards=st.num_server_shards,
                nets=self.shard_nets if self.shard_nets is not None
                else self.net, addrs=self.transport_addrs, codec=st.codec,
                device=self.device)
            if st.shard_placement == "pull_frequency":
                if not isinstance(self.exchange, ShardedTransport):
                    raise ValueError(
                        "shard_placement='pull_frequency' needs the "
                        "sharded in-process transport (num_server_shards "
                        "> 1, transport != 'tcp'): "
                        f"{type(self.exchange).__name__} cannot migrate "
                        "rows")
                self.exchange.track_pulls = True
            self.ex_clients: list[ExchangeClient | None] = [
                None if self.shards[ci] is None else
                ExchangeClient(self.exchange, st.codec,
                               delta_threshold=st.delta_threshold,
                               error_feedback=st.error_feedback)
                for ci in range(self.k)]
        else:
            self.exchange = None
            self.ex_clients = [None] * self.k
        self._register_shard_nodes()
        self._build_client_state()
        self._build_eval_state()
        if self.model is None:
            self.model = init_gnn(
                self.conv, self.g.feat_dim, self.hidden, self.g.num_classes,
                self.L, generator=torch.Generator().manual_seed(self.seed),
                device=self.device)
        self.acc_history: list[float] = []   # finished-round accuracies

    def _build_shard_state(self) -> None:
        """Shards (retention-limited, then score-pruned to the top-f%
        pull nodes per client), reciprocal push sets, push-row indices
        and prefetch sets."""
        st = self.strategy
        limit = 0 if not st.use_embeddings else st.retention_limit
        scored = st.use_embeddings and st.scored_prune_frac is not None

        def keep_of(sh):
            scores = score_remote_nodes(sh, st.score_kind, self.L)
            return top_fraction(scores, st.scored_prune_frac,
                                rng=self._client_rng(sh.client_id, 1),
                                random_subset=st.random_subset,
                                device=self.device)

        if self._prebuilt_shards is not None:
            # prebuilt (mmap'd) shards: the graph is never re-scanned and
            # score-based pruning filters each owned shard on its own
            shards = list(self._prebuilt_shards)
            if scored:
                for ci in self.owned:
                    shards[ci] = filter_shard_remote(
                        shards[ci], shards[ci].pull_nodes[keep_of(shards[ci])])
        else:
            # every client's shard is extracted (the reciprocal push sets
            # need all pull sets), even under only_clients: bake shards
            # with launch/build_store where that matters.  Score-based
            # pruning (§4.1.2) is scored on the retention-pruned expanded
            # subgraph; the same seed keeps the same retention edges
            # before the set filter applies
            shards = self._build_shards(limit)
            if scored:
                retained = {sh.client_id: sh.pull_nodes[keep_of(sh)]
                            for sh in shards}
                shards = self._build_shards(limit, retained_remote=retained)
        self.shards = shards
        # a shard-local worker over prebuilt shards keeps the push sets
        # stored at build time (a superset under scored pruning: extra
        # pushed rows are never read)
        if all(sh is not None for sh in shards):
            assign_push_sets(shards, self.part)
        # push rows and prefetch scores (§4.3, on the final expanded
        # shard) for the owned clients only
        self.push_rows: list[np.ndarray | None] = [None] * self.k
        self.prefetch_sets: list[np.ndarray | None] = [None] * self.k
        for ci in self.owned:
            sh = shards[ci]
            self.push_rows[ci] = push_rows(sh)
            if st.use_embeddings and st.prefetch_frac is not None:
                scores = score_remote_nodes(sh, st.score_kind, self.L)
                idx = top_fraction(scores, st.prefetch_frac,
                                   rng=self._client_rng(ci, 2),
                                   random_subset=st.random_subset,
                                   device=self.device)
            else:
                idx = np.arange(len(sh.pull_nodes))
            self.prefetch_sets[ci] = idx

    def _register_shard_nodes(self) -> None:
        """Register the owned shards' pull and push sets with the
        exchange.  Registration is idempotent (the server's table keeps
        existing rows), so after a growth jump only the new boundary
        vertices matter: they are counted into the growth runtime's
        boundary-registration counter."""
        if self.exchange is None:
            return
        fresh = 0
        for ci in self.owned:
            sh = self.shards[ci]
            for gids in (sh.pull_nodes, sh.push_nodes):
                if self.growth is not None and len(gids):
                    fresh += len(np.setdiff1d(gids, self._registered))
                    self._registered = np.union1d(self._registered, gids)
                self.exchange.register(gids)
        if self.growth is not None and fresh:
            self.growth.record_boundary(fresh)

    def _build_client_state(self) -> None:
        """Per-client training state of the owned clients: samplers,
        shard arrays on the device, labels and zeroed embedding caches
        (None for a client another process owns)."""
        dev = self.device
        k = self.k
        self.samplers: list[NeighborSampler | None] = [None] * k
        self.shard_arrays: list[dict | None] = [None] * k
        self.feats: list[torch.Tensor | None] = [None] * k
        self.labels: list[torch.Tensor | None] = [None] * k
        self._caches: list[list[torch.Tensor] | None] = [None] * k
        for ci in self.owned:
            sh = self.shards[ci]
            self.samplers[ci] = NeighborSampler(
                sh, self.fanout, self.L, self.batch_size, seed=self.seed)
            self.shard_arrays[ci] = shard_to_arrays(sh, dev)
            self.feats[ci] = self.shard_arrays[ci]["features"]
            # a copy: a prebuilt shard's arrays are read-only file views
            self.labels[ci] = torch.from_numpy(
                np.array(sh.labels, np.int64)).to(dev)
            self._caches[ci] = [
                torch.zeros((max(1, sh.num_remote), self.hidden),
                            dtype=torch.float32, device=dev)
                for _ in range(self.L - 1)]

    def _build_eval_state(self) -> None:
        """The aggregation server's held-out test set: the whole graph,
        or past ``eval_max_edges`` a seeded uniform vertex sample whose
        induced edges fit the budget.  Shard-local workers never
        evaluate and skip it."""
        if self.only_clients is not None:
            self.eval_gids = self.eval_arrays = self.test_idx = None
            return
        if self.g.num_edges > self.eval_max_edges:
            sel = sampled_eval_vertices(self.g, self.eval_max_edges,
                                        self.seed)
        else:
            sel = np.arange(self.g.num_vertices, dtype=np.int64)
        self.eval_gids = sel
        self.eval_arrays = eval_arrays_for(self.g, sel, self.device)
        self.test_idx = np.nonzero(~np.asarray(self.g.train_mask[sel]))[0]

    # -- dynamic graphs (repro_torch.dyngraph) ----------------------------------

    def apply_growth(self, epoch: int,
                     round_idx: int | None = None) -> bool:
        """Advance the growth runtime to ``epoch`` and, if the graph
        jumped, swap in the merged view and rebuild every shard-derived
        structure (shards, push sets, samplers, device arrays, caches,
        eval sample).  The model and the exchange survive: only the new
        boundary vertices are registered (the server's capacity-doubling
        path).  ``round_idx`` stamps the jump so the plateau-τ schedule
        restarts from it.  → True when anything changed."""
        if self.growth is None:
            return False
        if not self.growth.advance_to(epoch, part=self.part):
            return False
        self.g = self.growth.graph
        self.part = self.growth.part
        if round_idx is not None:
            self._growth_round = int(round_idx)
            self._growth_accs_base = int(round_idx)
        self._refresh_after_growth()
        return True

    def _refresh_after_growth(self) -> None:
        self._prebuilt_shards = None    # extracted before the jump: stale
        self._build_shard_state()
        self._register_shard_nodes()
        self._build_client_state()
        self._build_eval_state()

    # -- params <-> leaves ------------------------------------------------------

    def params_leaves(self, params: GNN | None = None) -> list[np.ndarray]:
        """Host copies of the leaves of ``params`` (default: the global
        model) in the JAX package's ``tree_flatten`` order."""
        model = self.model if params is None else params
        return [p.detach().cpu().numpy().copy() for p in model.leaves()]

    def load_leaves(self, leaves) -> None:
        """Overwrite the global model from leaves in that order."""
        self.model.load_leaves(leaves)

    def leaves_to_params(self, leaves) -> GNN:
        """A copy of the global model holding ``leaves`` (the JAX
        package's order): the model a fedsvc worker trains from."""
        model = copy.deepcopy(self.model)
        model.load_leaves(leaves)
        return model

    def set_round_tau(self, round_idx: int, accuracies=None) -> None:
        """Apply the adaptive-τ schedule (Strategy.delta_schedule) for
        this round to every client's delta tracker.  After a growth jump
        the schedule restarts from the jump round: the linear warm-up
        ramps again, and the plateau detector sees only the accuracies
        since the jump."""
        tau = self.strategy.delta_for_round(
            round_idx - self._growth_round,
            list(self.acc_history if accuracies is None
                 else accuracies)[self._growth_accs_base:])
        if tau is None:
            return
        for ex in self.ex_clients:
            if ex is not None and ex.delta is not None:
                ex.delta.tau = tau

    # -- embedding exchange helpers ---------------------------------------------

    @property
    def server(self):
        """The embedding-server side of the exchange (a Transport)."""
        return self.exchange

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fill_cache(self, ci: int) -> None:
        """Materialise this round's pull-node embeddings into the client
        cache; values go through the wire codec."""
        sh = self.shards[ci]
        if self.exchange is None or len(sh.pull_nodes) == 0:
            return
        with TRACE.span("client.pull", args={"client": ci,
                                             "rows": len(sh.pull_nodes)},
                        sync=self._sync):
            self._caches[ci] = fill_cache(self.ex_clients[ci], sh, self.L)

    def _pull_time(self, ci: int, minibatches: list[MiniBatch]
                   ) -> tuple[float, float, list[int]]:
        """(upfront pull s, dynamic pull s, nodes-per-dynamic-RPC sizes)."""
        sh = self.shards[ci]
        st = self.strategy
        ex = self.ex_clients[ci]
        if self.exchange is None or len(sh.pull_nodes) == 0:
            return 0.0, 0.0, []
        if st.prefetch_frac is None:
            return ex.pull_cost(sh.pull_nodes), 0.0, []
        # §4.3: batched prefetch of top-x% + per-minibatch on-demand RPCs.
        pre = self.prefetch_sets[ci]
        t_pre = ex.pull_cost(sh.pull_nodes[pre])
        present = [np.zeros(sh.num_remote, bool) for _ in range(self.L - 1)]
        for p in present:
            p[pre] = True
        t_dyn, sizes = 0.0, []
        for mb in minibatches:
            miss_gids = []
            for l, used in enumerate(mb.remote_slots_used):
                miss = used[~present[l][used]]
                if len(miss):
                    # remote slot i ↔ sh.pull_nodes[i]
                    miss_gids.append(sh.pull_nodes[miss])
                present[l][miss] = True
            if miss_gids:
                gids = np.concatenate(miss_gids)
                t_dyn += ex.dynamic_pull(gids)
                sizes.append(len(gids))
        return t_pre, t_dyn, sizes

    def _compute_push(self, ci: int, params: GNN
                      ) -> tuple[Optional[PushPlan], float, float]:
        """Forward pass for push-node embeddings (§3.2.2 push phase).
        Returns (delta-filtered+encoded push plan, compute s, transfer s)."""
        sh = self.shards[ci]
        if self.exchange is None or len(sh.push_nodes) == 0:
            return None, 0.0, 0.0
        # synchronised while recording, the span also holds the device
        # work plan_push enqueues (the codec's encode)
        with TRACE.span("client.push_compute", args={"client": ci},
                        sync=self._sync):
            t0 = time.perf_counter()
            outs = params.full_propagate(self.shard_arrays[ci],
                                         self._caches[ci])
            self._sync()
            t_compute = time.perf_counter() - t0
            rows = torch.from_numpy(self.push_rows[ci]).to(self.device)
            plan = self.ex_clients[ci].plan_push(
                sh.push_nodes, [outs[l][rows] for l in range(self.L - 1)])
        return plan, t_compute, plan.transfer_time

    # -- lifecycle ---------------------------------------------------------------

    def pretrain_round(self, client_ids: list[int] | None = None) -> None:
        """§3.2.1: initialise push-node embeddings on the unexpanded local
        subgraphs (remote neighbours masked) and seed the server, through
        each client's own exchange client (its delta shadow and residuals
        start from these rows).  A fedsvc worker passes its own
        ``client_ids``, so each process seeds exactly the rows it owns."""
        if self.exchange is None:
            return
        for ci in (self.owned if client_ids is None else client_ids):
            push_bootstrap(self.model, self.shards[ci], self.shard_arrays[ci],
                           self.ex_clients[ci])

    def export_for_serving(self) -> dict:
        """Publish the trained state for the serving plane: every owned
        vertex's h^1..h^{L-1} through a plain client (see the module
        function of the same name).  Returns the bundle
        ``gnnserve.build_serving`` consumes."""
        if self.exchange is None:
            raise RuntimeError("export_for_serving needs an embedding-"
                               "sharing strategy (use_embeddings=True)")
        return export_for_serving(self.model,
                                  [self.shards[ci] for ci in self.owned],
                                  self.part, self.exchange,
                                  self.strategy.codec, device=self.device)

    def evaluate(self, params: GNN | None = None) -> float:
        if self.eval_arrays is None:
            raise RuntimeError(
                "shard-local trainer (only_clients=...) has no eval "
                "graph; evaluation belongs to the coordinator")
        model = self.model if params is None else params
        outs = model.full_propagate(self.eval_arrays, None)
        pred = torch.argmax(outs[-1], dim=-1).cpu().numpy()
        truth = np.asarray(self.g.labels[self.eval_gids[self.test_idx]])
        return float((pred[self.test_idx] == truth).mean())

    def train_minibatches(self, ci: int, params: GNN, opt_state,
                          batches) -> tuple[GNN, object, list[torch.Tensor]]:
        """Client ``ci``'s train steps over ``batches``: loss, gradients
        through the aggregation's backward, one optimizer step each.
        ``params`` is updated in place and returned with the optimizer
        state and the per-step losses (device scalars, not synchronised)."""
        feats, labels, caches = self.feats[ci], self.labels[ci], \
            self._caches[ci]
        leaves = params.leaves()
        losses = []
        # spans without args and unsynchronised: no dict or span object
        # per minibatch while the recorder is off, and no device wait;
        # fine, so their rate cannot push the round's spans out of the ring
        for mb in batches:
            with TRACE.span("step.copy", fine=True):
                batch = blocks_to_arrays(mb, self.device)
            with TRACE.span("step.forward", fine=True):
                loss = loss_fn(params, batch, feats, caches, labels)
            with TRACE.span("step.backward", fine=True):
                grads = torch.autograd.grad(loss, leaves)
            with TRACE.span("step.optim", fine=True):
                new, opt_state = self.opt.step(leaves, grads, opt_state)
                with torch.no_grad():
                    for p, v in zip(leaves, new):
                        p.copy_(v)
            losses.append(loss.detach())
        return params, opt_state, losses

    def client_round(self, ci: int, params: GNN | None = None, *,
                     fill_cache: bool = True) -> ClientRoundResult:
        """One client's share of a round: cache fill (pull), sampling,
        local epochs, push planning.  The returned push plan is *not*
        applied — the caller commits it once every client has pulled
        (server static within the round, §4.2)."""
        st = self.strategy
        sh = self.shards[ci]
        p = PhaseTimes()
        if fill_cache:
            self._fill_cache(ci)
        # pre-sample the round's minibatches (sampling is part of the
        # measured train phase, like DGL's dataloader)
        t0 = time.perf_counter()
        epochs_batches = [list(self.samplers[ci].epoch())
                          for _ in range(self.epochs)]
        sample_t = time.perf_counter() - t0
        p.pull, p.dynamic_pull, sizes = self._pull_time(
            ci, [mb for ep in epochs_batches for mb in ep])

        params = copy.deepcopy(self.model if params is None else params)
        opt_state = self.opt.init(params.leaves())
        t_train = sample_t
        push_plan: Optional[PushPlan] = None
        losses: list[torch.Tensor] = []
        for e, batches in enumerate(epochs_batches, start=1):
            t0 = time.perf_counter()
            with TRACE.span("client.train_epoch",
                            args={"client": ci, "epoch": e}):
                params, opt_state, ep_losses = self.train_minibatches(
                    ci, params, opt_state, batches)
                losses += ep_losses
                self._sync()
            t_train += time.perf_counter() - t0
            if st.overlap_push and e == self.epochs - 1:
                # §4.2: stale push computed from the epoch-(ε−1) model
                push_plan, p.push_compute, p.push_transfer = \
                    self._compute_push(ci, params)
        if not st.overlap_push or self.epochs < 2:
            push_plan, p.push_compute, p.push_transfer = \
                self._compute_push(ci, params)
        p.train = t_train
        return ClientRoundResult(
            client_id=ci, params=params, phases=p, rpc_sizes=sizes,
            push_plan=push_plan,
            weight=float(len(sh.train_vertices())),
            loss=float(losses[-1]) if losses else 0.0,
            client_time=p.client_total(
                overlap=st.overlap_push,
                interference=st.overlap_interference, epochs=self.epochs))

    def aggregate(self, results: list[ClientRoundResult]) -> float:
        """FedAvg of the clients' models (fp32 leaves, ascending client
        order) into the global model, then its accuracy on the eval
        graph."""
        results = sorted(results, key=lambda r: r.client_id)
        agg = fedavg_leaves([self.params_leaves(r.params) for r in results],
                            [r.weight for r in results])
        self.load_leaves(agg)
        return self.evaluate()

    def run_round(self, round_idx: int, cum_time: float) -> RoundStats:
        if self.only_clients is not None:
            raise RuntimeError(
                "run_round needs every client; shard-local trainers drive "
                "client_round through the fedsvc control plane")
        TRACE.set_context(round=round_idx)
        self.set_round_tau(round_idx)
        # pull-frequency shard rebalancing: after the first round's pulls
        # are logged, re-place hot rows across the embedding-server shards
        # by observed pull counts (LPT); numerics are untouched, only the
        # per-shard time and byte ledgers move
        st = self.strategy
        if st.use_embeddings and st.shard_placement == "pull_frequency" \
                and round_idx == st.rebalance_round:
            self.exchange.rebalance_by_pulls()
        phases = PhaseTimes()
        all_rpc_sizes: list[int] = []
        results = [self.client_round(ci) for ci in range(self.k)]
        for res in results:
            all_rpc_sizes += res.rpc_sizes
            for name in ("pull", "train", "dynamic_pull", "push_compute",
                         "push_transfer"):
                setattr(phases, name, max(getattr(phases, name),
                                          getattr(res.phases, name)))
        # all clients pulled before anyone pushes (server is static
        # within the round) — apply the planned pushes now.
        for res in results:
            if res.push_plan is not None:
                with TRACE.span("client.push_apply", sync=self._sync):
                    self.ex_clients[res.client_id].apply_push(res.push_plan)
        t0 = time.perf_counter()
        with TRACE.span("round.aggregate", args={"round": round_idx}):
            acc = self.aggregate(results)
        t_agg = time.perf_counter() - t0 \
            + 2 * self.net.model_transfer_time(self._num_params())
        phases.agg = t_agg
        self.acc_history.append(acc)
        round_time = max(res.client_time for res in results) + t_agg
        return RoundStats(
            round_idx=round_idx,
            accuracy=acc,
            round_time=round_time,
            cum_time=cum_time + round_time,
            phases=phases,
            pull_rpc_sizes=all_rpc_sizes,
            embeddings_stored=0 if self.exchange is None
            else self.exchange.num_embeddings_stored,
            train_loss=float(np.mean([res.loss for res in results])),
        )

    def train(self, num_rounds: int, *, verbose: bool = False
              ) -> list[RoundStats]:
        self.pretrain_round()
        stats: list[RoundStats] = []
        cum = 0.0
        for r in range(num_rounds):
            if self.growth is not None:
                self.apply_growth(self.growth.epoch_for_round(r), r)
            s = self.run_round(r, cum)
            cum = s.cum_time
            stats.append(s)
            if verbose:
                print(f"  round {r:3d} acc={s.accuracy:.4f} "
                      f"loss={s.train_loss:.3f} t={s.round_time:.3f}s "
                      f"(pull {s.phases.pull:.3f} train {s.phases.train:.3f} "
                      f"dyn {s.phases.dynamic_pull:.3f} "
                      f"push {s.phases.push_compute + s.phases.push_transfer:.3f})")
        return stats

    def _num_params(self) -> int:
        return sum(p.numel() for p in self.model.leaves())
