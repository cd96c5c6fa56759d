"""CLI: GNN inference-serving frontend.

Port of ``repro/launch/gnn_serve.py``, with its flags plus ``--device``
(default ``cuda``).  It trains a federated run from the shared RunConfig
flags (so the served model is pinned by the same argv contract as the
fedsvc launchers), exports the trained parameters and final boundary
embeddings into the serving plane
(:meth:`FederatedGNNTrainer.export_for_serving`), and answers
``PT_OP_PREDICT`` queries over TCP until a shutdown frame arrives.  With
``--embed`` addresses the embeddings live on TCP embedding servers and
the plane's cache refreshes through ``PT_OP_VGATHER``.

    python -m repro_torch.launch.gnn_serve --port 0 \\
        --graph reddit --scale 0.05 --graph-seed 3 \\
        --clients 2 --strategy E --rounds 2 \\
        --cache-rows 50000 --serve-fanout 10 --depth-schedule 1,2,3

    # a prebuilt store (python -m repro_torch.launch.build_store), on the CPU
    python -m repro_torch.launch.gnn_serve --port 0 \\
        --graph store:STORE_DIR --clients 2 --device cpu

It prints "gnn_serve listening on HOST:PORT" once it answers, and the
plane's stats as one JSON line on exit.  Query it with
:class:`repro_torch.gnnserve.frontend.GnnServeClient` (or the JAX
package's client: the frames are the same).
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch.fedsvc.runtime import RunConfig
from repro_torch.gnnserve import build_serving
from repro_torch.gnnserve.frontend import serve_in_thread
from repro_torch.obsv.trace import TRACE


def build_plane_from_cfg(cfg: RunConfig, *, cache_rows: int,
                         serve_fanout: int, batch_size: int,
                         depth_schedule=None, quiet: bool = False,
                         device: str = "cuda"):
    """Train ``cfg.rounds`` rounds in-process on ``device``, export, and
    build the plane there.  Shared by the CLI and ``chip_smoke.py``, so
    both serve the identical model."""
    trainer = cfg.build_trainer(device=device)
    trainer.pretrain_round()
    for rnd in range(cfg.rounds):
        stats = trainer.run_round(rnd, 0.0)
        if not quiet:
            print(f"round {rnd}: acc={stats.accuracy:.4f}", flush=True)
    bundle = trainer.export_for_serving()
    plane = build_serving(bundle, cache_rows=cache_rows,
                          serve_fanout=serve_fanout, batch_size=batch_size,
                          depth_schedule=depth_schedule, device=device)
    return trainer, plane


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="GNN node-prediction serving frontend")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 picks an ephemeral port (printed on start)")
    ap.add_argument("--cache-rows", type=int, default=100_000,
                    help="hot-embedding cache capacity (rows, LRU)")
    ap.add_argument("--serve-fanout", type=int, default=10,
                    help="deterministic per-hop neighbour cap at serve time")
    ap.add_argument("--serve-batch", type=int, default=64,
                    help="padded forward batch size of the query batcher")
    ap.add_argument("--depth-schedule", default=None,
                    help="comma-separated ascending early-exit depths "
                         "ending at num-layers (default 1,..,L)")
    RunConfig.add_args(ap)                 # adds --device (default cuda)
    args = ap.parse_args(argv)

    cfg = RunConfig.from_args(args)
    sched = None
    if args.depth_schedule:
        sched = [int(d) for d in args.depth_schedule.split(",")]
    t0 = time.perf_counter()
    _trainer, plane = build_plane_from_cfg(
        cfg, cache_rows=args.cache_rows, serve_fanout=args.serve_fanout,
        batch_size=args.serve_batch, depth_schedule=sched,
        device=args.device)
    print(f"trained + exported in {time.perf_counter() - t0:.1f}s",
          flush=True)

    handle = serve_in_thread(plane, host=args.host, port=args.port)
    TRACE.set_process(f"gnn_serve:{handle.port}")
    print(f"gnn_serve listening on {handle.host}:{handle.port} "
          f"shards={sorted(plane.engines)} "
          f"schedule={next(iter(plane.engines.values())).depth_schedule}",
          flush=True)
    try:
        while not handle.stopped:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        handle.stop()
        print(json.dumps(plane.stats()), flush=True)


if __name__ == "__main__":
    main()
