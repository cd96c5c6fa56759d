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
Graph stores (``graph="store:<dir>"``, ``ROADMAP.md`` Queue A item 4)
and graph growth (item 5) are refused, naming their item.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from repro_torch.core.federated import FederatedGNNTrainer
from repro_torch.core.strategies import Strategy, default_strategies


@dataclasses.dataclass
class RunConfig:
    #: synthetic preset name ("reddit", scaled by ``scale``/``graph_seed``);
    #: the JAX package also takes "store:<dir>", which is not ported
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
    #: dynamic graphs (a GrowthSchedule dict in the JAX package); only
    #: None runs here
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
            raise NotImplementedError(
                f"graph={self.graph!r}: graph stores are not ported yet "
                "(ROADMAP.md Queue A item 4)")
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
        just those clients (the fed_worker path)."""
        if self.growth:
            raise NotImplementedError(
                "growth=...: dynamic graphs are not ported yet "
                "(ROADMAP.md Queue A item 5)")
        st = self.build_strategy()
        if embeddings is False:
            st = dataclasses.replace(st, use_embeddings=False,
                                     transport="auto")
        addrs = self.embed_addrs or None
        if not st.use_embeddings or st.transport != "tcp":
            addrs = None
        return FederatedGNNTrainer(
            self.build_graph(), self.num_clients, st,
            conv=self.conv, num_layers=self.num_layers,
            hidden=self.hidden, fanout=self.fanout,
            batch_size=self.batch_size,
            epochs_per_round=self.epochs_per_round, lr=self.lr,
            transport_addrs=addrs, seed=self.seed,
            only_clients=only_clients, device=device)

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
                        help="GrowthSchedule as JSON: not ported yet "
                             "(ROADMAP.md Queue A item 5), refused")
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

    def init_leaves(self):
        return self.trainer.params_leaves()

    def evaluate_leaves(self, leaves) -> float:
        tr = self.trainer
        return tr.evaluate(tr.leaves_to_params(leaves))


def make_coordinator_state(cfg: RunConfig, *, harness: EvalHarness | None
                           = None, net=None, device: str = "cuda"):
    """One CoordinatorState wired from a RunConfig's strategy: the single
    place the control-plane knobs (aggregation mode, FedBuff buffer,
    weight codec, client sampling) flow from the Strategy into the
    coordinator.  ``device`` is where the harness evaluates and the
    weight codec runs."""
    from .coordinator import CoordinatorState   # avoid an import cycle
    if cfg.growth:
        raise NotImplementedError(
            "growth=...: dynamic graphs are not ported yet "
            "(ROADMAP.md Queue A item 5)")
    st = cfg.build_strategy()
    harness = EvalHarness(cfg, device=device) if harness is None else harness
    return CoordinatorState(
        num_clients=cfg.num_clients, num_rounds=cfg.rounds,
        mode=st.aggregation, buffer_size=st.buffer_size,
        staleness_decay=st.staleness_decay,
        weight_codec=st.weight_codec,
        sample_frac=st.sample_frac, sample_seed=cfg.seed,
        init_leaves=harness.init_leaves(),
        eval_fn=harness.evaluate_leaves, net=net, device=device)
