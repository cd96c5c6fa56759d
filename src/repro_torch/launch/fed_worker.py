"""CLI: one federated client-worker process.

Port of ``repro/launch/fed_worker.py``, with the same flags and stdout
lines plus ``--device``.  It owns one or more clients of the deployment,
rebuilds the graph, partition and model from the shared RunConfig flags,
trains its clients' share of every round on ``--device``, exchanges
embeddings with the embed shards (``--embed``, repeatable) and weights
with the coordinator (``--coordinator``).

    python -m repro_torch.launch.fed_worker --coordinator 127.0.0.1:7050 \\
        --client-ids 0 --graph reddit --scale 0.05 --graph-seed 3 \\
        --clients 2 --strategy E --rounds 2 \\
        --embed 127.0.0.1:7040 --embed 127.0.0.1:7041 [--device cpu]

``--growth JSON`` (a ``GrowthSchedule`` dict, the coordinator's too)
grows the worker's own replica of the graph at each round the
coordinator's growth epoch names, and reports it at the growth barrier.
Scenario injection (``--pacing``, ``--straggler-s``, ``--dropout-prob``,
``--drop-round`` with ``--rejoin``) as in the JAX launcher.
``--obs-port`` runs a telemetry-only listener so ``obs_dump`` can scrape
this worker; ``--obs-linger S`` keeps it up for S seconds after the run,
ending early when standard input closes, so a caller can scrape the
finished round and then release the worker.  Over a TCP embedding wire
it also prints ``fed_worker <id> wire {...}``: its measured and modelled
RPC seconds by opcode and the NetworkModel fitted to its RPCs
(:func:`wire_summary`).  It prints one JSON line per completed round and then
``fed_worker <id> DONE`` (or DROPPED / DISCONNECTED).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

from repro_torch.core.cost_model import fit_network_model
from repro_torch.fedsvc.runtime import RunConfig
from repro_torch.fedsvc.worker import FedWorker, WorkerScenario
from repro_torch.obsv import teleserve
from repro_torch.obsv.trace import TRACE


def wire_summary(transport) -> dict:
    """A TcpTransport's RPCs by opcode (count, payload bytes, measured
    and modelled seconds) and the NetworkModel fitted to its embedding
    RPCs (every fan-out: the shards of one RPC are read in turn, so a
    later shard's time includes the earlier reads)."""
    ops: dict[str, dict] = {}
    rows = []
    for r in transport.rpc_samples:
        o = ops.setdefault(r.op, {"rpcs": 0, "bytes": 0, "measured_s": 0.0,
                                  "modelled_s": 0.0})
        o["rpcs"] += 1
        o["bytes"] += r.payload_bytes
        o["measured_s"] += r.measured_s
        o["modelled_s"] += r.modelled_s
        if r.op != "register":
            rows.append((r.payload_bytes, 1, r.n_rows * r.layers,
                         r.measured_s))
    out = {"ops": ops}
    if len(rows) >= 3:
        fit = fit_network_model(rows)
        out["fit"] = {"bandwidth_bytes_per_s": fit.bandwidth_bytes_per_s,
                      "rpc_overhead_s": fit.rpc_overhead_s,
                      "per_embedding_overhead_s":
                      fit.per_embedding_overhead_s, "samples": len(rows)}
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="Federated client worker (repro_torch.fedsvc protocol)")
    ap.add_argument("--coordinator", required=True, metavar="HOST:PORT")
    ap.add_argument("--client-ids", required=True,
                    help="comma-separated client indices this worker owns")
    ap.add_argument("--worker-id", default=None)
    ap.add_argument("--pacing", type=float, default=1.0)
    ap.add_argument("--straggler-s", type=float, default=0.0)
    ap.add_argument("--dropout-prob", type=float, default=0.0)
    ap.add_argument("--scenario-seed", type=int, default=0)
    ap.add_argument("--drop-round", type=int, default=None,
                    help="die deterministically mid-round N (once)")
    ap.add_argument("--rejoin", action="store_true",
                    help="reconnect + re-hello after a drop instead of "
                         "staying dead")
    ap.add_argument("--rejoin-delay-s", type=float, default=0.5)
    ap.add_argument("--obs-port", type=int, default=None,
                    help="run a telemetry-only listener on this port "
                         "(OP_METRICS/OP_TRACE) so obs_dump can scrape "
                         "this worker")
    ap.add_argument("--obs-linger", type=float, default=0.0,
                    help="keep the telemetry listener up this many "
                         "seconds after the run, or until standard input "
                         "closes")
    RunConfig.add_args(ap)
    args = ap.parse_args(argv)

    cfg = RunConfig.from_args(args)
    client_ids = [int(c) for c in args.client_ids.split(",") if c != ""]
    scenario = WorkerScenario(pacing=args.pacing,
                              straggler_s=args.straggler_s,
                              dropout_prob=args.dropout_prob,
                              seed=args.scenario_seed,
                              drop_round=args.drop_round,
                              rejoin=args.rejoin,
                              rejoin_delay_s=args.rejoin_delay_s)
    t0 = time.perf_counter()
    worker = FedWorker(cfg, client_ids, args.coordinator,
                       worker_id=args.worker_id, scenario=scenario,
                       device=args.device)
    TRACE.set_process(f"fed_worker:{worker.worker_id}")
    obs = None
    if args.obs_port is not None:
        obs = teleserve.serve_telemetry(port=args.obs_port)
        print(f"fed_worker telemetry on {obs.host}:{obs.port}",
              flush=True)
    print(f"fed_worker {worker.worker_id} clients={client_ids} "
          f"coordinator={args.coordinator} device {args.device} "
          f"setup {time.perf_counter() - t0:.3f} s", flush=True)
    try:
        records = worker.run()
        for rec in records:
            print(json.dumps(rec), flush=True)
        ex = worker.trainer.exchange
        if getattr(ex, "wire_is_real", False):
            print(f"fed_worker {worker.worker_id} wire "
                  f"{json.dumps(wire_summary(ex))}", flush=True)
        status = "DROPPED" if worker.dropped else \
            "DISCONNECTED" if worker.disconnected else "DONE"
        rejoined = f" rejoins={worker.rejoins}" if worker.rejoins else ""
        print(f"fed_worker {worker.worker_id} {status}{rejoined}",
              flush=True)
        if obs is not None and args.obs_linger > 0:
            closed = threading.Event()
            threading.Thread(target=lambda: (sys.stdin.read(), closed.set()),
                             daemon=True).start()
            closed.wait(args.obs_linger)
    finally:
        if obs is not None:
            obs.stop()


if __name__ == "__main__":
    main()
