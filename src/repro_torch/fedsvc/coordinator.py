"""Threaded TCP weight-aggregation coordinator.

Port of ``repro/fedsvc/coordinator.py``, speaking the same bytes: one
accept loop, one thread per worker connection, a lock + condition
variable over the shared round state.  Blocking RPCs (``get_model``,
``wait_pulled``) park their connection thread on the condition until the
round advances — workers never poll.  Port workers and JAX workers both
talk to it, as to the JAX coordinator.

Aggregation policies (Strategy.aggregation):

  sync  — barriered FedAvg.  A round aggregates when every sampled,
          active client's update arrived, in ascending client-id order
          through :func:`repro_torch.fedsvc.aggregation.fedavg_leaves`,
          the function the in-process trainer uses, so a multi-process
          sync round reproduces ``FederatedGNNTrainer.run_round``.
  async — FedBuff-style buffered aggregation.  Updates carry deltas
          (local − base model); every ``buffer_size`` arrivals the model
          moves by the staleness-discounted weighted mean of the
          buffered deltas (``staleness_decay ** staleness``) and the
          version bumps.  No barriers.

Dropout and churn: a worker whose connection dies is deregistered; the
pull barrier and the aggregation trigger re-evaluate against the
surviving clients, its not-yet-aggregated updates are dropped, and a
sync round only aggregates over ``sampled ∩ active ∩ updates``.  A
re-``hello`` with the same worker id on a fresh connection is a re-join.

Client sampling (Strategy.sample_frac): ceil(frac·K) clients drawn
deterministically from ``sample_seed`` and the round index (sync) /
model version (async).  Async get_model parks a worker none of whose
clients is sampled, an update from an unsampled client is refused, and a
version whose entire sample died is redrawn from the survivors.

Weight-wire compression (Strategy.weight_codec): get_model responses
are codec-encoded version diffs against a per-worker served view, and
updates arrive as codec-encoded deltas rebuilt against the same view;
the codec runs on ``device`` (the int8 kernels on the card).  Wire bytes
both ways are recorded per aggregation next to a codec-aware modelled
transfer time.

Dual ledgers, as TcpTransport keeps them: every aggregation records the
modelled round time next to the measured wall clock since serving
began.

Dynamic graphs (``growth=``, a :class:`repro_torch.dyngraph.GrowthSchedule`;
sync mode only): each get_model response carries the round's
``growth_epoch``, and the growth band (opcodes 48–63,
:mod:`repro_torch.dyngraph.wire`) is a barrier that withholds its reply
until every registered worker has applied that epoch.
"""

from __future__ import annotations

import math
import socket
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.cost_model import NetworkModel
from repro_torch.dyngraph import wire as dyn_wire
from repro_torch.exchange import wire
from repro_torch.exchange.codec import decode_leaves, encode_leaves
from repro_torch.obsv import teleserve
from repro_torch.obsv.metrics import REGISTRY
from repro_torch.obsv.trace import TRACE

from . import protocol
from .aggregation import (apply_buffered_deltas, fedavg_leaves, leaf_add,
                          staleness_scale)

_AGGS = REGISTRY.counter("pt_coord.aggregations")
_AGG_S = REGISTRY.histogram("pt_coord.agg_s")
_BARRIER_S = REGISTRY.histogram("pt_coord.barrier_wait_s")
_WEIGHT_BYTES = REGISTRY.counter("pt_coord.weight_bytes")


class CoordinatorState:
    """Shared state of one coordinator service."""

    def __init__(self, *, num_clients: int, num_rounds: int,
                 mode: str = "sync", buffer_size: int = 2,
                 staleness_decay: float = 0.5,
                 weight_codec: Optional[str] = None,
                 sample_frac: Optional[float] = None,
                 sample_seed: int = 0,
                 init_leaves: Optional[Sequence[np.ndarray]] = None,
                 eval_fn: Optional[Callable[[list[np.ndarray]], float]] = None,
                 net: NetworkModel | None = None,
                 growth=None,
                 device: str = "cuda"):
        if mode not in ("sync", "async"):
            raise ValueError(f"unknown aggregation mode {mode!r}")
        if sample_frac is not None and not 0.0 < sample_frac <= 1.0:
            raise ValueError(f"sample_frac {sample_frac!r} not in (0, 1]")
        if growth is not None and mode != "sync":
            # growth epochs are keyed to the sync round index; async
            # versions have no shared round boundary to apply deltas at
            raise ValueError("dynamic-graph growth requires sync "
                             "aggregation")
        self.num_clients = num_clients
        self.num_rounds = num_rounds          # sync: rounds; async: aggs
        self.mode = mode
        self.buffer_size = max(1, buffer_size)
        self.staleness_decay = staleness_decay
        self.weight_codec = weight_codec
        self.sample_frac = sample_frac
        self.sample_seed = sample_seed
        self.eval_fn = eval_fn
        self.net = net or NetworkModel()
        # where the weight codec runs; immutable — read without the lock
        self.device = device
        # growth schedule (anything with epoch_for_round) or None;
        # immutable — read without the lock
        self.growth = growth

        self.cond = threading.Condition()
        self.stop = threading.Event()
        # every mutable field below is shared across connection threads
        self.leaves: Optional[list[np.ndarray]] = (     # guarded-by: self.cond
            None if init_leaves is None
            else [np.asarray(l) for l in init_leaves])
        self.round = 0                # sync round index; guarded-by: self.cond
        self.version = 0              # async agg count; guarded-by: self.cond
        self.serial = 0               # bumps per agg; guarded-by: self.cond
        self.workers: dict[str, set[int]] = {}    # worker -> clients; guarded-by: self.cond
        self._conn_worker: dict[int, str] = {}    # conn id -> worker; guarded-by: self.cond
        self._worker_conn: dict[str, int] = {}    # worker -> live conn; guarded-by: self.cond
        self.pulled: set[int] = set()             # this round; guarded-by: self.cond
        self.updates: dict[int, dict] = {}        # cid -> record; guarded-by: self.cond
        self.buffer: list[dict] = []              # async pending; guarded-by: self.cond
        self.history: list[dict] = []             # per aggregation; guarded-by: self.cond
        self.acc_history: list[float] = []        # guarded-by: self.cond
        self.cum_modelled_s = 0.0                 # guarded-by: self.cond
        self._t0: Optional[float] = None  # first model served; guarded-by: self.cond
        self._assembled = False   # all K registered; guarded-by: self.cond
        self._aggregating = False  # async drain in flight; guarded-by: self.cond
        # weight codec: per-worker (serial, leaves) of the view that
        # worker holds — version diffs are computed/reconstructed
        # against it, and it tracks the worker's copy bit-identically
        self._served: dict[str, tuple[int, list[np.ndarray]]] = {}  # guarded-by: self.cond
        self._samples: dict[int, set[int]] = {}         # guarded-by: self.cond
        # dynamic graphs: highest growth epoch each worker reported
        # applied — the growth barrier predicate reads it
        self.grown: dict[str, int] = {}                 # guarded-by: self.cond
        # weight-plane wire ledger (payload bytes of get_model responses
        # and update requests), per aggregation and cumulative
        self.weight_bytes_cum = 0                       # guarded-by: self.cond
        self._dl_bytes = self._ul_bytes = 0             # guarded-by: self.cond
        self._dl_max = self._ul_max = 0                 # guarded-by: self.cond

    # -- helpers (call with self.cond held) --------------------------------

    @property
    def active_clients(self) -> set[int]:  # guarded-by: self.cond
        out: set[int] = set()
        for cids in self.workers.values():
            out |= cids
        return out

    @property
    def assembled(self) -> bool:  # guarded-by: self.cond
        """Latches True once every client id registered.  get_model
        gates on this so no worker starts round 0 before all workers
        finished their pretrain pushes (a later dropout must not
        un-assemble an already-running deployment)."""
        if not self._assembled \
                and len(self.active_clients) == self.num_clients:
            self._assembled = True
        return self._assembled

    @property
    def done(self) -> bool:  # guarded-by: self.cond
        count = self.round if self.mode == "sync" else self.version
        return count >= self.num_rounds

    def _num_params(self) -> int:  # guarded-by: self.cond
        return sum(int(np.prod(l.shape)) for l in self.leaves or [])

    def _wall(self) -> float:  # guarded-by: self.cond
        return 0.0 if self._t0 is None else time.perf_counter() - self._t0

    def _wait(self, predicate) -> None:  # guarded-by: self.cond
        while not predicate() and not self.stop.is_set():
            self.cond.wait(timeout=0.2)
        if self.stop.is_set() and not predicate():
            raise ConnectionError("coordinator stopping")

    def _sampled(self, idx: int) -> set[int]:  # guarded-by: self.cond
        """The client set aggregation step ``idx`` runs over — the round
        index in sync mode, the model version in async (call with cond
        held).  Drawn lazily from the clients active at draw time —
        deterministic in (sample_seed, idx) — and cached so barrier,
        aggregation, and every worker's get_model agree."""
        if self.sample_frac is None:
            return self.active_clients
        sel = self._samples.get(idx)
        if sel is None:
            pool = sorted(self.active_clients)
            if not pool:
                return set()               # nobody yet: don't cache
            # ceil(frac·K) as documented; the epsilon keeps float noise
            # (0.2 * 5 == 1.0000000000000002) from bumping a whole client
            k = max(1, math.ceil(self.sample_frac * self.num_clients
                                 - 1e-9))
            rng = np.random.default_rng((self.sample_seed, idx))
            sel = set(int(c) for c in
                      rng.choice(pool, size=min(k, len(pool)),
                                 replace=False))
            self._samples[idx] = sel
        return sel

    # -- weight-plane wire ledger ------------------------------------------

    def _charge_wire(self, direction: str, nbytes: int) -> None:  # guarded-by: self.cond
        """Record one weight-plane message (call with cond held)."""
        if direction == "down":
            self._dl_bytes += nbytes
            self._dl_max = max(self._dl_max, nbytes)
        else:
            self._ul_bytes += nbytes
            self._ul_max = max(self._ul_max, nbytes)
        self.weight_bytes_cum += nbytes
        _WEIGHT_BYTES.inc(nbytes)

    def _weight_ledger(self) -> dict:  # guarded-by: self.cond
        """Close out this aggregation's weight-wire ledger: actual bytes
        both directions plus the codec-aware modelled exchange time (the
        critical path is one largest download + one largest upload, the
        per-client exchange of the historical ``2·model_transfer_time``
        — now priced at the effective bytes/param actually framed)."""
        n = max(1, self._num_params())
        modelled = (
            self.net.model_transfer_time(n, bytes_per_scalar=self._dl_max / n)
            + self.net.model_transfer_time(n,
                                           bytes_per_scalar=self._ul_max / n))
        out = {"weight_down_bytes": self._dl_bytes,
               "weight_up_bytes": self._ul_bytes,
               "weight_bytes": self._dl_bytes + self._ul_bytes,
               "weight_modelled_s": modelled}
        self._dl_bytes = self._ul_bytes = 0
        self._dl_max = self._ul_max = 0
        return out

    # -- aggregation -------------------------------------------------------

    def _maybe_aggregate_sync(self) -> None:  # guarded-by: self.cond
        if self.done:
            return
        active = self.active_clients
        eligible = self._sampled(self.round) & active
        # aggregate over the surviving sampled set only: an update whose
        # worker deregistered mid-round is an orphan and must not fold
        # into FedAvg (the old `active <= updates` check let it through)
        if not eligible or not eligible <= set(self.updates):
            return
        ups = [self.updates[cid] for cid in sorted(eligible)]
        t0 = time.perf_counter()
        with TRACE.span("coord.aggregate",
                        args={"round": self.round, "mode": "sync",
                              "clients": len(ups)}):
            self.leaves = fedavg_leaves([u["leaves"] for u in ups],
                                        [u["weight"] for u in ups])
            acc = self.eval_fn(self.leaves) if self.eval_fn \
                else float("nan")
        ledger = self._weight_ledger()
        _AGGS.inc()
        _AGG_S.observe(time.perf_counter() - t0)
        agg_s = time.perf_counter() - t0 + ledger["weight_modelled_s"]
        round_modelled = max(u["modelled_s"] for u in ups) + agg_s
        self.cum_modelled_s += round_modelled
        self.acc_history.append(acc)
        self.history.append({
            "round": self.round, "mode": "sync", "accuracy": acc,
            "clients": sorted(eligible),
            "mean_loss": float(np.mean([u["loss"] for u in ups])),
            "round_modelled_s": round_modelled,
            "cum_modelled_s": self.cum_modelled_s,
            "round_measured_s": max(u["measured_s"] for u in ups) + agg_s,
            "max_barrier_s": max(u.get("barrier_s", 0.0) for u in ups),
            "wall_s": self._wall(),
            **ledger,
        })
        self.round += 1
        self.serial += 1
        self.pulled.clear()
        self.updates.clear()
        self.cond.notify_all()

    def _maybe_aggregate_async(self) -> None:  # guarded-by: self.cond
        """Drain the buffer under the lock, but fold + evaluate OUTSIDE
        it — the whole point of async mode is that workers never wait,
        and a full-graph eval under the coordinator's one condition
        lock would stall every concurrent RPC.  ``_aggregating`` keeps
        drains strictly sequential (the model moves one buffer at a
        time); updates arriving during a drain just queue for the next
        one, which the loop picks up after publishing."""
        while not self.done and not self._aggregating \
                and len(self.buffer) >= self.buffer_size:
            ups, self.buffer = self.buffer, []
            version = self.version
            base = self.leaves                # replaced, never mutated
            self._aggregating = True
            self.cond.release()
            try:
                t0 = time.perf_counter()
                with TRACE.span("coord.aggregate",
                                args={"version": version, "mode": "async",
                                      "buffered": len(ups)}):
                    scaled = [(u["weight"],
                               staleness_scale(version - u["version"],
                                               self.staleness_decay),
                               u["leaves"]) for u in ups]
                    leaves = apply_buffered_deltas(base, scaled)
                    acc = self.eval_fn(leaves) if self.eval_fn \
                        else float("nan")
                compute_s = time.perf_counter() - t0
                _AGGS.inc()
                _AGG_S.observe(compute_s)
            finally:
                self.cond.acquire()
                self._aggregating = False
            ledger = self._weight_ledger()
            agg_s = compute_s + ledger["weight_modelled_s"]
            self.leaves = leaves
            # async rounds overlap across workers: the modelled ledger
            # advances by the slowest *buffered* contribution amortized
            # over the buffer — with no barrier, client rounds pipeline,
            # so the marginal cost per aggregation is one buffer drain,
            # not a max-over-everyone round.
            round_modelled = max(u["modelled_s"] for u in ups) \
                / max(1, len(ups)) + agg_s
            self.cum_modelled_s += round_modelled
            self.acc_history.append(acc)
            self.history.append({
                "round": self.version, "mode": "async", "accuracy": acc,
                "clients": sorted(u["client_id"] for u in ups),
                "staleness": [version - u["version"] for u in ups],
                "mean_loss": float(np.mean([u["loss"] for u in ups])),
                "round_modelled_s": round_modelled,
                "cum_modelled_s": self.cum_modelled_s,
                "round_measured_s": max(u["measured_s"] for u in ups)
                + agg_s,
                "wall_s": self._wall(),
                **ledger,
            })
            self.version += 1
            self.serial += 1
            self.cond.notify_all()

    # -- connection lifecycle ----------------------------------------------

    def disconnect(self, conn_id: int) -> None:
        """Connection died (worker dropout): deregister its clients and
        let any barrier / aggregation blocked on them re-evaluate.  A
        stale connection of a worker that already re-registered on a
        newer one must NOT deregister the live worker."""
        with self.cond:
            worker = self._conn_worker.pop(conn_id, None)
            if worker is None or self._worker_conn.get(worker) != conn_id:
                return
            self._worker_conn.pop(worker, None)
            self.workers.pop(worker, None)
            self._served.pop(worker, None)    # re-join gets a full model
            self.grown.pop(worker, None)      # re-join re-reports its epoch
            if self.mode == "sync":
                # orphaned updates: a deregistered client's pending
                # update must not survive into any aggregation — if all
                # workers die, stale updates would otherwise wedge the
                # round (or worse, aggregate the moment one re-joins)
                active = self.active_clients
                for cid in [c for c in self.updates if c not in active]:
                    del self.updates[cid]
                # a sampled round whose entire sample died can never
                # complete: skip ahead so survivors re-draw next round
                while (not self.done and self.sample_frac is not None
                       and self.active_clients
                       and not (self._sampled(self.round)
                                & self.active_clients)):
                    self.round += 1
                    self.pulled.clear()
                    self.updates.clear()
                self._maybe_aggregate_sync()
            else:
                # async: a version whose entire sample died would park
                # every survivor in get_model forever — redraw it from
                # the clients still standing
                if (not self.done and self.sample_frac is not None
                        and self.active_clients
                        and not (self._sampled(self.version)
                                 & self.active_clients)):
                    self._samples.pop(self.version, None)
                    self._sampled(self.version)
            self.cond.notify_all()

    # -- request dispatch --------------------------------------------------

    def handle(self, conn_id: int, body: bytes) -> bytes:
        """One request body → one response body (never raises; blocking
        ops wait on the condition inside)."""
        # shared telemetry opcodes first: their bodies don't follow the
        # fedsvc `op | header_len | JSON` layout, so they must not reach
        # protocol.parse_body
        telemetry = teleserve.handle_telemetry(body)
        if telemetry is not None:
            return telemetry
        # dynamic-graph band (48..63): its own wire layout and exchange
        # status replies, so it must not reach protocol.parse_body
        if body and dyn_wire.GROWTH_LO <= body[0] <= dyn_wire.GROWTH_HI:
            try:
                return self._op_growth(body)
            except ConnectionError:
                raise                  # let the conn loop tear down
            except Exception as e:
                return wire.build_err(f"{type(e).__name__}: {e}")
        try:
            op, header, tensors = protocol.parse_body(body)
        except Exception as e:
            return protocol.build_err(f"bad request: {type(e).__name__}: {e}")
        try:
            if op == protocol.PT_OP_HELLO:
                return self._op_hello(conn_id, header, tensors)
            if op == protocol.PT_OP_GET_MODEL:
                return self._op_get_model(conn_id, header)
            if op == protocol.PT_OP_PULLED:
                return self._op_pulled(header)
            if op == protocol.PT_OP_WAIT_PULLED:
                return self._op_wait_pulled(header)
            if op == protocol.PT_OP_UPDATE:
                return self._op_update(conn_id, header, tensors)
            if op == protocol.PT_OP_COORD_STATS:
                return self._op_stats()
            if op == protocol.PT_OP_COORD_SHUTDOWN:
                self.stop.set()
                with self.cond:
                    self.cond.notify_all()
                return protocol.build_ok()
            return protocol.build_err(f"unknown opcode {op}")
        except ConnectionError:
            raise                      # let the conn loop tear down
        except Exception as e:
            return protocol.build_err(f"{type(e).__name__}: {e}")

    def _op_hello(self, conn_id: int, header: dict, tensors) -> bytes:
        worker = str(header["worker_id"])
        cids = set(int(c) for c in header["client_ids"])
        bad = [c for c in cids if not 0 <= c < self.num_clients]
        if bad:
            return protocol.build_err(
                f"client ids {sorted(bad)} out of range for "
                f"num_clients={self.num_clients}")
        if header.get("has_init") and not tensors:
            # an empty init would seed a zero-parameter model and the
            # coordinator would happily serve it; refuse loudly instead
            return protocol.build_err(
                "has_init with no model leaves: empty init rejected")
        with self.cond:
            taken = set()
            for w, o in self.workers.items():
                if w != worker:
                    taken |= o & cids
            if taken:
                return protocol.build_err(
                    f"client ids {sorted(taken)} already registered "
                    "to another worker")
            resumed = worker in self.workers
            self.workers[worker] = cids
            self._conn_worker[conn_id] = worker
            self._worker_conn[worker] = conn_id
            # fresh registration or re-join: whatever view we tracked
            # for this worker id is gone with the old process/connection
            self._served.pop(worker, None)
            if header.get("has_init") and self.leaves is None:
                self.leaves = [np.asarray(t) for t in tensors]
            if self._t0 is None:
                self._t0 = time.perf_counter()
            self.cond.notify_all()
            return protocol.build_ok({
                "round": self.round, "version": self.version,
                "mode": self.mode, "num_clients": self.num_clients,
                "num_rounds": self.num_rounds, "resumed": resumed})

    def _op_get_model(self, conn_id: int, header: dict) -> bytes:
        want = int(header.get("round", 0))
        have = int(header.get("have_version", -1))
        with self.cond:
            if self.mode == "sync":
                self._wait(lambda: self.assembled
                           and (self.round >= want or self.done))
            else:
                # async + sampling: an unsampled worker parks here until
                # a version samples one of its clients — that is what
                # rate-limits it (merely filtering in the worker would
                # let it spin on get_model at full speed)
                def _async_ready() -> bool:
                    if not (self.assembled and self.leaves is not None):
                        return False
                    if self.done or self.sample_frac is None:
                        return True
                    cids = self.workers.get(
                        self._conn_worker.get(conn_id), set())
                    return not cids or \
                        bool(cids & self._sampled(self.version))
                self._wait(_async_ready)
            if self.leaves is None:
                return protocol.build_err("no model: no worker sent init "
                                          "leaves yet")
            # raw path: snapshot refs only — aggregation *replaces*
            # self.leaves, never mutates it, so the (large) tensor
            # serialization runs outside the coordinator's one condition
            # lock.  The codec path below instead encodes under the
            # lock: the per-worker served view must advance atomically
            # with the diff, and at GNN model sizes (tens of kB) the
            # encode is microseconds — revisit with per-worker locks if
            # models grow orders of magnitude.
            leaves = self.leaves
            head = {"round": self.round, "version": self.version,
                    "serial": self.serial, "done": self.done,
                    "accs": list(self.acc_history)}
            if self.growth is not None:
                # every worker of this round sees the same epoch, so
                # they all check into the growth barrier (or all skip)
                head["growth_epoch"] = int(
                    self.growth.epoch_for_round(self.round))
            if self.sample_frac is not None and not self.done:
                head["sampled"] = sorted(self._sampled(
                    self.round if self.mode == "sync" else self.version))
            worker = self._conn_worker.get(conn_id)
            served = self._served.get(worker) if worker else None
            if self.weight_codec is not None and worker is not None:
                if served is not None and served[0] == have:
                    # version diff against the exact view this worker
                    # holds; the new view is base + decode(diff) on
                    # BOTH ends (leaf_add), so they stay bit-identical
                    # and codec error self-corrects next diff
                    diff = [np.asarray(c, np.float32) - b
                            for c, b in zip(leaves, served[1])]
                    payload, shapes = encode_leaves(self.weight_codec, diff,
                                                    device=self.device)
                    view = leaf_add(served[1],
                                    decode_leaves(self.weight_codec,
                                                  payload, shapes,
                                                  device=self.device))
                    head.update(kind="delta", codec=self.weight_codec,
                                shapes=shapes)
                else:
                    # first fetch or re-join: full raw model, which
                    # becomes the worker's view as-is
                    payload, view = leaves, leaves
                    head["kind"] = "full"
                self._served[worker] = (self.serial, view)
            else:
                payload = leaves
                head["kind"] = "full"
            self._charge_wire("down", wire.tensors_nbytes(payload))
        return protocol.build_ok(head, payload)

    def _op_growth(self, body: bytes) -> bytes:
        """Growth barrier: a worker reports the growth epoch it just
        applied; the reply is withheld until every registered worker
        has applied that epoch, so no worker pulls embeddings across a
        half-grown deployment (a boundary row registered by one worker
        must exist before a neighbour's pull).  A dropped worker leaves
        ``self.workers`` in :meth:`disconnect`, which notifies the
        condition and lets the barrier re-evaluate."""
        _, header = dyn_wire.parse_growth_request(body)
        worker = str(header["worker_id"])
        epoch = int(header["epoch"])
        with self.cond, TRACE.span(
                "coord.growth",
                args={"round": int(header.get("round", -1)),
                      "epoch": epoch}):
            self.grown[worker] = max(epoch, self.grown.get(worker, 0))
            self.cond.notify_all()
            self._wait(lambda: all(self.grown.get(w, 0) >= epoch
                                   for w in self.workers))
        return wire.build_ok()

    def _op_pulled(self, header: dict) -> bytes:
        rnd = int(header["round"])
        with self.cond:
            if rnd == self.round:
                self.pulled |= set(int(c) for c in header["client_ids"])
                self.cond.notify_all()
            return protocol.build_ok()

    def _op_wait_pulled(self, header: dict) -> bytes:
        rnd = int(header["round"])
        t0 = time.perf_counter()
        with self.cond, TRACE.span("coord.barrier", args={"round": rnd}):
            # barrier: every *surviving sampled* client pulled, or the
            # round already moved on (a late waiter must not deadlock)
            self._wait(lambda: self.round != rnd
                       or (self._sampled(rnd)
                           & self.active_clients) <= self.pulled)
            _BARRIER_S.observe(time.perf_counter() - t0)
            return protocol.build_ok()

    def _op_update(self, conn_id: int, header: dict, tensors) -> bytes:
        tensors = [np.asarray(t) for t in tensors]
        rec = {
            "client_id": int(header["client_id"]),
            "weight": float(header["weight"]),
            "loss": float(header.get("loss", float("nan"))),
            "modelled_s": float(header.get("modelled_s", 0.0)),
            "measured_s": float(header.get("measured_s", 0.0)),
            "barrier_s": float(header.get("barrier_s", 0.0)),
        }
        codec = header.get("codec") if header.get("kind") == "delta" \
            else None
        with self.cond:
            if codec is not None:
                delta = decode_leaves(codec, tensors, header["shapes"],
                                      device=self.device)
            if self.mode == "sync":
                rnd = int(header["round"])
                if rnd != self.round:
                    return protocol.build_err(
                        f"update for round {rnd} but coordinator is at "
                        f"round {self.round}")
                if codec is not None:
                    # codec-encoded delta vs the worker's served view:
                    # reconstruct the full local params for FedAvg
                    worker = self._conn_worker.get(conn_id)
                    served = self._served.get(worker) if worker else None
                    if served is None:
                        return protocol.build_err(
                            "delta update without a served model view "
                            "(get_model must precede update)")
                    rec["leaves"] = leaf_add(served[1], delta)
                else:
                    rec["leaves"] = tensors
                # charge only accepted updates: a refused or ignored
                # payload must not inflate the round's weight ledger
                # (the bytes the int8-vs-raw comparison is made of)
                self._charge_wire("up", wire.tensors_nbytes(tensors))
                self.updates[rec["client_id"]] = rec
                self._maybe_aggregate_sync()
            else:
                version = int(header["version"])
                if self.sample_frac is not None and \
                        rec["client_id"] not in self._sampled(version):
                    # not sampled at the version it trained from: the
                    # update neither buffers nor charges the wire ledger
                    # (it should not have been computed — the get_model
                    # park exists so this only happens on races)
                    return protocol.build_ok(
                        {"round": self.round, "version": self.version,
                         "done": self.done, "accepted": False})
                # async updates are deltas by construction; a codec just
                # changes the wire form, so the decode is all it takes
                rec["leaves"] = delta if codec is not None else tensors
                rec["version"] = version
                self._charge_wire("up", wire.tensors_nbytes(tensors))
                self.buffer.append(rec)
                self._maybe_aggregate_async()
            return protocol.build_ok({"round": self.round,
                                      "version": self.version,
                                      "done": self.done,
                                      "accepted": True})

    def _op_stats(self) -> bytes:
        with self.cond:
            return protocol.build_ok({
                "mode": self.mode, "round": self.round,
                "version": self.version, "serial": self.serial,
                "done": self.done,
                "weight_codec": self.weight_codec,
                "sample_frac": self.sample_frac,
                "weight_bytes_cum": self.weight_bytes_cum,
                "workers": {w: sorted(c) for w, c in self.workers.items()},
                "accs": list(self.acc_history),
                "cum_modelled_s": self.cum_modelled_s,
                "wall_s": self._wall(),
                "history": [{k: v for k, v in h.items()}
                            for h in self.history],
            })


# -- service plumbing (mirrors launch/embed_server) ---------------------------

class CoordinatorHandle:
    """A running coordinator: address for workers, ``stop()``/``join()``
    for teardown, ``state`` for in-process inspection."""

    def __init__(self, state: CoordinatorState, sock: socket.socket,
                 thread: threading.Thread):
        self.state = state
        self._sock = sock
        self._thread = thread
        self.host, self.port = sock.getsockname()[:2]

    @property
    def address(self) -> tuple[str, int]:
        return (self.host, self.port)

    def join(self, timeout: float = 60.0) -> bool:
        """Wait until training is done (all rounds aggregated)."""
        deadline = time.monotonic() + timeout
        with self.state.cond:
            while not self.state.done and not self.state.stop.is_set():
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self.state.cond.wait(timeout=min(0.2, left))
        return self.state.done

    def stop(self, timeout: float = 5.0) -> None:
        self.state.stop.set()
        with self.state.cond:
            self.state.cond.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def _client_loop(conn: socket.socket, conn_id: int,
                 state: CoordinatorState) -> None:
    try:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while not state.stop.is_set():
            body = wire.recv_frame(conn)
            if body is None:
                break
            wire.send_frame(conn, state.handle(conn_id, body))
    except (ConnectionError, OSError):
        pass
    finally:
        state.disconnect(conn_id)
        try:
            conn.close()
        except OSError:
            pass


def _accept_loop(listener: socket.socket, state: CoordinatorState) -> None:
    listener.settimeout(0.2)
    threads: list[threading.Thread] = []
    conn_id = 0
    while not state.stop.is_set():
        try:
            conn, _ = listener.accept()
        except socket.timeout:
            continue
        except OSError:
            break
        conn_id += 1
        t = threading.Thread(target=_client_loop,
                             args=(conn, conn_id, state), daemon=True)
        t.start()
        threads.append(t)
    try:
        listener.close()
    except OSError:
        pass
    for t in threads:
        t.join(0.5)


def serve_in_thread(state: CoordinatorState, *, host: str = "127.0.0.1",
                    port: int = 0) -> CoordinatorHandle:
    """Start the coordinator on a background thread (ephemeral port by
    default) and return its handle."""
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind((host, port))
    listener.listen(64)
    thread = threading.Thread(target=_accept_loop, args=(listener, state),
                              daemon=True)
    thread.start()
    return CoordinatorHandle(state, listener, thread)
