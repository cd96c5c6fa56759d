"""RunConfig: one declarative description of a federated deployment.

Port of ``repro/fedsvc/runtime.py``.  Every participant of a
control-plane run (the coordinator CLI, each worker CLI, tests) must
build the same graph, partition, samplers and model init, or the
distributed round diverges from the in-process trainer.  RunConfig
captures everything those constructions depend on and rebuilds them
deterministically (synthetic graphs from ``(preset, scale,
graph_seed)``; partitions, samplers and model init from ``seed``), so a
JSON blob or an argv vector pins a deployment; its JSON is the JAX
package's, field for field.

The device is per process, not a field: :meth:`RunConfig.build_trainer`
and :class:`EvalHarness` take it.  A port participant's initial leaves
come from the port's seeded init, which is not JAX's: a deployment that
mixes the two packages seeds every participant from one set of leaves.
``graph="store:<dir>"`` opens a prebuilt mmap graph store
(``python -m repro_torch.launch.build_store``).  ``growth`` (a
:class:`repro_torch.dyngraph.GrowthSchedule` as a dict) makes every
participant build its own :class:`~repro_torch.dyngraph.GrowthRuntime`,
so workers in different processes grow alike without exchanging graph
state; the coordinator only synchronises when they advance.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from repro_torch.core.federated import FederatedGNNTrainer
from repro_torch.core.strategies import Strategy, default_strategies


@dataclasses.dataclass
class RunConfig:
    #: synthetic preset name ("reddit", scaled by ``scale``/``graph_seed``)
    #: or an out-of-core graph spec "store:<dir>": a prebuilt mmap
    #: GraphStore every participant opens read-only (its baked partition
    #: and shard files make a worker load exactly its clients' shards
    #: instead of regenerating the graph per process)
    graph: str = "reddit"
    scale: float = 0.05
    graph_seed: int = 3
    num_clients: int = 2
    strategy: str = "E"
    # Strategy field overrides (codec, delta_threshold, aggregation,
    # buffer_size, error_feedback, ...) applied via dataclasses.replace
    overrides: dict = dataclasses.field(default_factory=dict)
    conv: str = "graphconv"
    num_layers: int = 3
    hidden: int = 32
    fanout: int = 5
    batch_size: int = 64
    epochs_per_round: int = 3
    lr: float = 1e-2
    seed: int = 0
    rounds: int = 2
    embed_addrs: list = dataclasses.field(default_factory=list)
    #: dynamic graphs: a GrowthSchedule as a plain dict
    #: (``GrowthSchedule.to_dict()``, JSON-safe, so a RunConfig blob
    #: still pins the deployment).  None = static graph.  Every
    #: participant builds its own GrowthRuntime from it, so workers in
    #: different processes grow identically without exchanging state.
    growth: Optional[dict] = None

    # -- construction ------------------------------------------------------

    def build_strategy(self) -> Strategy:
        base = default_strategies()[self.strategy]
        over = dict(self.overrides)
        if self.embed_addrs and "transport" not in over:
            over["transport"] = "tcp"
        return dataclasses.replace(base, **over) if over else base

    def build_graph(self):
        if self.graph.startswith("store:"):
            from repro_torch.graphstore import open_store
            return open_store(self.graph[len("store:"):])
        from repro_torch.graphs import make_graph
        return make_graph(self.graph, scale=self.scale,
                          seed=self.graph_seed)

    def build_trainer(self, *, embeddings: Optional[bool] = None,
                      only_clients: Optional[list] = None,
                      device: str = "cuda") -> FederatedGNNTrainer:
        """The trainer a worker runs ``client_round`` on, its model and
        tensors on ``device``.  ``embeddings=False`` builds a
        participant that only needs model init and evaluation (the
        coordinator): no exchange, never a touch of the embed shards.
        ``only_clients`` builds samplers, caches and registrations for
        just those clients (the fed_worker path); on a ``store:`` graph
        with prebuilt shard files the worker then mmaps only its own
        shards and never re-scans the graph."""
        st = self.build_strategy()
        if embeddings is False:
            st = dataclasses.replace(st, use_embeddings=False,
                                     transport="auto")
        addrs = self.embed_addrs or None
        if not st.use_embeddings or st.transport != "tcp":
            addrs = None
        g = self.build_graph()
        part, shards = None, None
        if getattr(g, "is_store", False):
            part = g.load_partition(self.num_clients, self.seed)
            limit = st.retention_limit if st.use_embeddings else 0
            if part is not None and \
                    g.has_shards(self.num_clients, self.seed, limit):
                owned = range(self.num_clients) if only_clients is None \
                    else only_clients
                shards = [None] * self.num_clients
                for c in owned:
                    shards[c] = g.load_shard(c, self.num_clients,
                                             self.seed, limit)
        growth = None
        if self.growth:
            from repro_torch.dyngraph import GrowthRuntime, GrowthSchedule
            growth = GrowthRuntime(
                GrowthSchedule.from_dict(self.growth), g,
                self.num_clients, method=st.restream,
                passes=st.restream_passes, seed=self.seed)
        return FederatedGNNTrainer(
            g, self.num_clients, st,
            conv=self.conv, num_layers=self.num_layers,
            hidden=self.hidden, fanout=self.fanout,
            batch_size=self.batch_size,
            epochs_per_round=self.epochs_per_round, lr=self.lr,
            transport_addrs=addrs, seed=self.seed, part=part,
            shards=shards, only_clients=only_clients, growth=growth,
            device=device)

    # -- (de)serialisation -------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, blob: str) -> "RunConfig":
        return cls(**json.loads(blob))

    # -- argparse plumbing (shared by both CLIs) ---------------------------

    @staticmethod
    def add_args(ap) -> None:
        ap.add_argument("--graph", default="reddit")
        ap.add_argument("--scale", type=float, default=0.05)
        ap.add_argument("--graph-seed", type=int, default=3)
        ap.add_argument("--clients", type=int, default=2,
                        help="total number of federated clients K")
        ap.add_argument("--strategy", default="E",
                        help="strategy name from default_strategies()")
        ap.add_argument("--set", action="append", default=[],
                        metavar="FIELD=VALUE", dest="overrides",
                        help="Strategy field override, JSON-valued "
                             "(e.g. --set codec='\"int8\"' "
                             "--set delta_threshold=0.05); bare strings "
                             "also accepted (--set codec=int8)")
        ap.add_argument("--conv", default="graphconv")
        ap.add_argument("--num-layers", type=int, default=3)
        ap.add_argument("--hidden", type=int, default=32)
        ap.add_argument("--fanout", type=int, default=5)
        ap.add_argument("--batch-size", type=int, default=64)
        ap.add_argument("--epochs", type=int, default=3)
        ap.add_argument("--lr", type=float, default=1e-2)
        ap.add_argument("--seed", type=int, default=0)
        ap.add_argument("--rounds", type=int, default=2)
        ap.add_argument("--embed", action="append", default=[],
                        metavar="HOST:PORT", dest="embed_addrs",
                        help="embed_server shard address (repeatable)")
        ap.add_argument("--growth", default=None, metavar="JSON",
                        help="GrowthSchedule as JSON (repro_torch.dyngraph): "
                             "the run applies seeded growth events at "
                             "round boundaries")
        ap.add_argument("--device", default="cuda",
                        help="where this process trains and evaluates "
                             "(cuda | cpu)")

    @classmethod
    def from_args(cls, args) -> "RunConfig":
        overrides = {}
        for item in args.overrides:
            key, _, val = item.partition("=")
            try:
                overrides[key] = json.loads(val)
            except json.JSONDecodeError:
                overrides[key] = val          # bare string convenience
        return cls(graph=args.graph, scale=args.scale,
                   graph_seed=args.graph_seed, num_clients=args.clients,
                   strategy=args.strategy, overrides=overrides,
                   conv=args.conv, num_layers=args.num_layers,
                   hidden=args.hidden, fanout=args.fanout,
                   batch_size=args.batch_size, epochs_per_round=args.epochs,
                   lr=args.lr, seed=args.seed, rounds=args.rounds,
                   embed_addrs=list(args.embed_addrs),
                   growth=json.loads(args.growth)
                   if getattr(args, "growth", None) else None)


class EvalHarness:
    """The coordinator's model-side hooks: deterministic init leaves and
    held-out evaluation, built from the same RunConfig as the workers
    (embeddings off: the coordinator never touches the embed shards)."""

    def __init__(self, cfg: RunConfig, *, device: str = "cuda"):
        self.trainer = cfg.build_trainer(embeddings=False, device=device)
        self._evals = 0     # completed evaluations == closed sync rounds

    def init_leaves(self):
        return self.trainer.params_leaves()

    def evaluate_leaves(self, leaves) -> float:
        tr = self.trainer
        if tr.growth is not None:
            # sync aggregation evaluates once per round, in round order:
            # evaluation r closes round r, whose graph carries
            # epoch_for_round(r), the jump the workers applied at the
            # top of the round, so the held-out sample tracks the grown
            # graph
            tr.apply_growth(tr.growth.epoch_for_round(self._evals),
                            self._evals)
        self._evals += 1
        return tr.evaluate(tr.leaves_to_params(leaves))


def make_coordinator_state(cfg: RunConfig, *, harness: EvalHarness | None
                           = None, net=None, device: str = "cuda"):
    """One CoordinatorState wired from a RunConfig's strategy: the single
    place the control-plane knobs (aggregation mode, FedBuff buffer,
    weight codec, client sampling) flow from the Strategy into the
    coordinator.  ``device`` is where the harness evaluates and the
    weight codec runs."""
    from .coordinator import CoordinatorState   # avoid an import cycle
    st = cfg.build_strategy()
    harness = EvalHarness(cfg, device=device) if harness is None else harness
    growth = None
    if cfg.growth:
        from repro_torch.dyngraph import GrowthSchedule
        growth = GrowthSchedule.from_dict(cfg.growth)
    return CoordinatorState(
        num_clients=cfg.num_clients, num_rounds=cfg.rounds,
        mode=st.aggregation, buffer_size=st.buffer_size,
        staleness_decay=st.staleness_decay,
        weight_codec=st.weight_codec,
        sample_frac=st.sample_frac, sample_seed=cfg.seed,
        init_leaves=harness.init_leaves(),
        eval_fn=harness.evaluate_leaves, net=net, growth=growth,
        device=device)
