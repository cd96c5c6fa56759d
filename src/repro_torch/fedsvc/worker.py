"""FedWorker: the client-process side of the control plane.

Port of ``repro/fedsvc/worker.py``.  A worker owns one or more clients
of the deployment and runs their share of every round through
:meth:`repro_torch.core.federated.FederatedGNNTrainer.client_round` —
sampling, pulls through ExchangeClient (TcpTransport against the embed
shards), local epochs, overlap push planning — and exchanges weights
with the coordinator over
:class:`repro_torch.fedsvc.protocol.CoordinatorClient`.  It loads the
coordinator's leaves into its :class:`~repro_torch.models.gnn.GNN` and
hands back ``params_leaves`` in the JAX package's leaf order, so a port
worker and a JAX coordinator (or the reverse) interoperate.

Sync round protocol (bit-compatible with the in-process trainer)::

    get_model(r)            # blocks until round r open (+ assembly)
    fill caches (pull)      # the round's only embedding reads
    pulled(r)               # non-blocking notify
    client_round(...)       # local epochs; push planned, not applied
    wait_pulled(r)          # barrier: server static within the round
    apply push plans        # embedding writes land
    update(r, params, ...)  # coordinator FedAvgs when all K arrived

Async (FedBuff-style): no barriers — pull, train, push, submit
``delta = local − base`` tagged with the model version it trained from,
then fetch the newest model and go again.

Weight wire (Strategy.weight_codec): the worker ships each client's
update as a codec-encoded delta (local − held model; the int8 codec runs
on ``device``) with a per-client :class:`LeafErrorFeedback` carry, and
consumes get_model responses that may be version diffs against the model
view it holds — the coordinator tracks that view bit-identically.

Client sampling: a get_model response may carry the ``sampled`` client
set; the worker trains only those of its clients, and a sync worker with
none skips the round.

Scenario injection (:class:`WorkerScenario`): pacing, a fixed straggler
delay and a pull delay stretch the measured wall clock (real sleeps) and
the modelled ledger alike; a dropout probability or a deterministic
``drop_round`` kills the worker mid-round (after its pull, before its
update), and with ``rejoin`` it comes back on a fresh connection.

Dynamic graphs: when a sync get_model response carries a
``growth_epoch``, the worker applies it to its trainer
(:meth:`~repro_torch.core.federated.FederatedGNNTrainer.apply_growth`)
and checks into the coordinator's growth barrier
(:func:`repro_torch.dyngraph.wire.growth_rpc`) before its sampled skip,
so an unsampled worker cannot wedge the sampled ones.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.core.federated import FederatedGNNTrainer
from repro_torch.dyngraph import wire as dyn_wire
from repro_torch.exchange.codec import decode_leaves, encode_leaves
from repro_torch.exchange.delta import LeafErrorFeedback
from repro_torch.obsv.metrics import REGISTRY
from repro_torch.obsv.trace import TRACE

from .aggregation import leaf_add, leaf_sub
from .protocol import CoordinatorClient
from .runtime import RunConfig

_BARRIER_S = REGISTRY.histogram("pt_worker.barrier_s")
_ROUND_S = REGISTRY.histogram("pt_worker.round_s")
_ROUNDS = REGISTRY.counter("pt_worker.rounds")


@dataclasses.dataclass
class WorkerScenario:
    """Injected heterogeneity for one worker."""
    pacing: float = 1.0         # >1: this worker is uniformly slower
    straggler_s: float = 0.0    # fixed extra seconds per round
    pull_delay_s: float = 0.0   # extra seconds in the pull phase (sync:
                                # lands before `pulled`, so it is what
                                # everyone else's wait_pulled barrier sees)
    dropout_prob: float = 0.0   # per-round chance of dying mid-round
    seed: int = 0
    # deterministic churn: die exactly once, mid-round `drop_round`
    # (sync) / mid-iteration `drop_round` (async); with rejoin=True the
    # worker reconnects after rejoin_delay_s instead of staying dead
    drop_round: Optional[int] = None
    rejoin: bool = False
    rejoin_delay_s: float = 0.5

    def round_delay(self, measured_train_s: float) -> float:
        return max(0.0, (self.pacing - 1.0) * measured_train_s) \
            + self.straggler_s


class WorkerDropout(Exception):
    """Raised internally when the scenario kills the worker mid-round."""


class FedWorker:
    def __init__(self, cfg: RunConfig, client_ids: list[int],
                 coordinator_addr, *, worker_id: str | None = None,
                 scenario: WorkerScenario | None = None,
                 trainer: FederatedGNNTrainer | None = None,
                 device: str = "cuda"):
        self.cfg = cfg
        self.client_ids = sorted(int(c) for c in client_ids)
        self.addr = coordinator_addr
        self.worker_id = worker_id or \
            "worker-" + "-".join(str(c) for c in self.client_ids)
        self.scenario = scenario or WorkerScenario()
        self._rng = np.random.default_rng(self.scenario.seed)
        # shard-local trainer: samplers / caches / exchange registrations
        # only for the owned clients, on ``device``
        self.trainer = trainer if trainer is not None \
            else cfg.build_trainer(only_clients=self.client_ids,
                                   device=device)
        self.device = str(self.trainer.device)
        st = self.trainer.strategy
        self.weight_codec: str | None = st.weight_codec
        self._wef: dict[int, LeafErrorFeedback] = {
            ci: LeafErrorFeedback() for ci in self.client_ids
        } if (self.weight_codec is not None
              and st.weight_error_feedback) else {}
        self._view: list[np.ndarray] | None = None  # model we hold
        self._view_serial = -1
        self.records: list[dict] = []     # one per completed local round
        self.dropped = False              # scenario killed this worker
        self.disconnected = False         # coordinator went away mid-run
        self.rejoins = 0                  # completed re-join cycles
        self._drop_fired = False          # drop_round fires exactly once

    # -- lifecycle ---------------------------------------------------------

    def run(self) -> list[dict]:
        """Train until the coordinator reports done (or the scenario
        kills this worker).  Returns the per-round records."""
        tr = self.trainer
        # §3.2.1 pretrain: seed the embed shards with this worker's
        # rows *before* registering — the coordinator's assembly gate
        # guarantees nobody pulls until every worker got here.
        tr.pretrain_round(self.client_ids)
        first = True
        while True:
            try:
                client = CoordinatorClient(self.addr)
            except (ConnectionError, OSError):
                if first:
                    raise              # a dead address is a setup error
                self.disconnected = True   # coordinator gone mid-rejoin
                return self.records
            first = False
            try:
                hello = client.hello(self.worker_id, self.client_ids,
                                     init_leaves=tr.params_leaves())
                if hello["mode"] == "sync":
                    self._run_sync(client, start_round=int(hello["round"]))
                else:
                    self._run_async(client)
                return self.records
            except WorkerDropout:
                self.dropped = True
                if not self.scenario.rejoin:
                    return self.records
            except (ConnectionError, OSError):
                # the coordinator stopped (timeout, lingered out, or
                # died) mid-RPC: end gracefully, keeping the records
                self.disconnected = True
                return self.records
            finally:
                client.close()
            # re-join: fresh connection, same ids.  The held model view
            # and EF residuals describe a conversation that died with
            # the old connection — drop them and catch up from the
            # coordinator's current full model.
            self._view, self._view_serial = None, -1
            for ef in self._wef.values():
                ef.reset()
            time.sleep(self.scenario.rejoin_delay_s)
            self.dropped = False
            self.rejoins += 1

    def _maybe_drop(self, round_idx: int) -> None:
        sc = self.scenario
        if sc.drop_round is not None and not self._drop_fired \
                and round_idx == sc.drop_round:
            self._drop_fired = True
            raise WorkerDropout(self.worker_id)
        if sc.dropout_prob > 0 and self._rng.random() < sc.dropout_prob:
            raise WorkerDropout(self.worker_id)

    # -- weight wire -------------------------------------------------------

    def _fetch_model(self, client: CoordinatorClient, want_round: int
                     ) -> tuple[dict, list[np.ndarray]]:
        """get_model + view upkeep: apply a version diff to the held
        view, or adopt a full model; either way the result is the exact
        leaves the coordinator records as this worker's served view."""
        head, tensors = client.get_model(want_round,
                                         have_version=self._view_serial)
        if head.get("kind") == "delta":
            leaves = leaf_add(self._view,
                              decode_leaves(head["codec"], tensors,
                                            head["shapes"],
                                            device=self.device))
        else:
            leaves = tensors
        self._view = leaves
        self._view_serial = int(head.get("serial", -1))
        return head, leaves

    def _update_payload(self, ci: int, params_leaves: list[np.ndarray]
                        ) -> tuple[dict, list]:
        """One client's update for the wire: raw full leaves (legacy),
        or a codec-encoded delta vs the held view with EF carry."""
        if self.weight_codec is None:
            return {}, params_leaves
        delta = leaf_sub(params_leaves, self._view)
        ef = self._wef.get(ci)
        comp = ef.compensate(delta) if ef is not None else delta
        tensors, shapes = encode_leaves(self.weight_codec, comp,
                                        device=self.device)
        if ef is not None:
            ef.commit(comp, decode_leaves(self.weight_codec, tensors,
                                          shapes, device=self.device))
        return {"kind": "delta", "codec": self.weight_codec,
                "shapes": shapes}, tensors

    # -- sync --------------------------------------------------------------

    def _run_sync(self, client: CoordinatorClient, start_round: int) -> None:
        tr = self.trainer
        r = start_round
        while True:
            with TRACE.span("worker.get_model", args={"round": r}):
                head, leaves = self._fetch_model(client, r)
            if head["done"]:
                return
            r = int(head["round"])
            TRACE.set_context(round=r, worker=self.worker_id)
            # dynamic graphs: apply this round's growth epoch BEFORE the
            # sampled skip — every worker must check into the growth
            # barrier (an unsampled worker skipping it would wedge the
            # sampled workers waiting on its boundary registrations)
            ge = int(head.get("growth_epoch", 0))
            if ge > 0 and tr.growth is not None:
                with TRACE.span("worker.growth", args={"epoch": ge}):
                    tr.apply_growth(ge, r)
                    dyn_wire.growth_rpc(
                        client.sock,
                        {"worker_id": self.worker_id, "round": r,
                         "epoch": ge,
                         "num_vertices": int(tr.g.num_vertices),
                         "num_edges": int(tr.g.num_edges)})
            sampled = head.get("sampled")
            mine = self.client_ids if sampled is None else \
                [c for c in self.client_ids if c in sampled]
            if not mine:
                # none of our clients drawn this round: skip straight
                # to the next round's get_model (which blocks until the
                # sampled subset finishes aggregating)
                r += 1
                continue
            t_start = time.perf_counter()
            params = tr.leaves_to_params(leaves)
            tr.set_round_tau(r, head.get("accs", ()))
            pull_s = {}
            with TRACE.span("worker.pull", args={"clients": mine}):
                for ci in mine:
                    t0 = time.perf_counter()
                    tr._fill_cache(ci)
                    pull_s[ci] = time.perf_counter() - t0
                if self.scenario.pull_delay_s > 0:
                    time.sleep(self.scenario.pull_delay_s)
                client.pulled(r, mine)
            # dropout lands after the pull barrier contribution and
            # before any update — the nastiest spot for the coordinator
            self._maybe_drop(r)
            with TRACE.span("worker.train", args={"clients": mine}):
                results = [tr.client_round(ci, params, fill_cache=False)
                           for ci in mine]
            t_train = time.perf_counter() - t_start
            delay = self.scenario.round_delay(t_train)
            if delay > 0:
                time.sleep(delay)
            # the barrier wait is coordination stall, not this worker's
            # work: measured_s must not charge the slowest straggler's
            # round to every client (round_measured_s = max over
            # clients would then exceed any single worker's own work)
            t_barrier = time.perf_counter()
            with TRACE.span("worker.barrier"):
                client.wait_pulled(r)
            barrier_s = time.perf_counter() - t_barrier
            _BARRIER_S.observe(barrier_s)
            push_s = {}
            with TRACE.span("worker.push"):
                for res in results:
                    t0 = time.perf_counter()
                    if res.push_plan is not None:
                        tr.ex_clients[res.client_id].apply_push(
                            res.push_plan)
                    push_s[res.client_id] = time.perf_counter() - t0
            measured = time.perf_counter() - t_start - barrier_s
            _ROUNDS.inc()
            _ROUND_S.observe(measured)
            with TRACE.span("worker.update"):
                for res in results:
                    extra, payload = self._update_payload(
                        res.client_id, tr.params_leaves(res.params))
                    client.update(
                        {"round": r, "client_id": res.client_id,
                         "weight": res.weight, "loss": res.loss,
                         "modelled_s": res.client_time
                         * self.scenario.pacing
                         + self.scenario.straggler_s
                         + self.scenario.pull_delay_s,
                         "measured_s": measured, "barrier_s": barrier_s,
                         **extra},
                        payload)
            self.records.append({
                "round": r, "clients": mine,
                "measured_s": measured, "barrier_s": barrier_s,
                "modelled_s": max(res.client_time for res in results)
                * self.scenario.pacing + self.scenario.straggler_s
                + self.scenario.pull_delay_s,
                "losses": [res.loss for res in results],
                # per client: measured cache fill, local epochs and push
                # apply, and the wire's modelled pull and push
                "phases": {str(res.client_id): {
                    "pull_s": pull_s[res.client_id],
                    "train_s": res.phases.train,
                    "push_s": push_s[res.client_id],
                    "pull_modelled_s": res.phases.pull,
                    "push_modelled_s": res.phases.push_transfer}
                    for res in results}})
            r += 1

    # -- async -------------------------------------------------------------

    def _run_async(self, client: CoordinatorClient) -> None:
        tr = self.trainer
        it = 0
        while True:
            head, leaves = self._fetch_model(client, 0)
            if head["done"]:
                return
            version = int(head["version"])
            sampled = head.get("sampled")
            mine = self.client_ids if sampled is None else \
                [c for c in self.client_ids if c in sampled]
            if not mine:
                # the coordinator parks unsampled workers in get_model,
                # so this only happens when the version moved between
                # its wakeup and our read: refetch for the new version
                it += 1
                continue
            base = leaves
            params = tr.leaves_to_params(leaves)
            tr.set_round_tau(it, head.get("accs", ()))
            self._maybe_drop(it)
            head = {}
            for ci in mine:
                # delay baseline is per client: each client's update is
                # its own async round, and pacing must not compound over
                # earlier clients' train time + injected sleeps
                t_client = time.perf_counter()
                TRACE.set_context(round=it, worker=self.worker_id)
                with TRACE.span("worker.train",
                                args={"client": ci, "version": version}):
                    res = tr.client_round(ci, params)
                # no barrier by design: async trades the static-server
                # invariant for wall-clock, so the push lands at once
                with TRACE.span("worker.push"):
                    if res.push_plan is not None:
                        tr.ex_clients[ci].apply_push(res.push_plan)
                delay = self.scenario.round_delay(
                    time.perf_counter() - t_client)
                if delay > 0:
                    time.sleep(delay)
                measured = time.perf_counter() - t_client
                _ROUNDS.inc()
                _ROUND_S.observe(measured)
                if self.weight_codec is None:
                    extra, payload = {}, leaf_sub(
                        tr.params_leaves(res.params), base)
                else:
                    # _update_payload's delta base is the held view,
                    # which IS this iteration's base model
                    extra, payload = self._update_payload(
                        ci, tr.params_leaves(res.params))
                head = client.update(
                    {"version": version, "client_id": res.client_id,
                     "weight": res.weight, "loss": res.loss,
                     "modelled_s": res.client_time * self.scenario.pacing
                     + self.scenario.straggler_s,
                     "measured_s": measured, **extra},
                    payload)
                self.records.append({
                    "iteration": it, "client": ci, "version": version,
                    "measured_s": measured,
                    "modelled_s": res.client_time * self.scenario.pacing
                    + self.scenario.straggler_s,
                    "losses": [res.loss]})
            if head.get("done"):
                return
            it += 1


def run_in_thread(worker: FedWorker) -> threading.Thread:
    """Start ``worker.run()`` on a daemon thread (tests and the card's
    smoke run several workers inside one process; each owns its own
    trainer, and they share state only through the coordinator and the
    embed shards — the isolation real processes have)."""
    t = threading.Thread(target=worker.run, name=worker.worker_id,
                         daemon=True)
    t.start()
    return t
