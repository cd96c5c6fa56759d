"""CLI: the weight-aggregation coordinator service.

Port of ``repro/launch/fed_coordinator.py``, with the same flags and
stdout lines plus ``--device``.  One coordinator per deployment.  It
never touches the embed shards: it holds the global model, gates the
sync barriers (or drains the async buffer), FedAvg-aggregates and
evaluates on the held-out test set on ``--device``.

    python -m repro_torch.launch.fed_coordinator --port 0 \\
        --graph reddit --scale 0.05 --graph-seed 3 --clients 2 \\
        --strategy E --rounds 2 [--device cpu]

then point workers (``repro_torch.launch.fed_worker``, or the JAX
package's) at the host:port of its "listening on" line.  Sync/async, the
FedBuff knobs, weight-wire compression and client sampling come from the
strategy (``--set aggregation='"async"' --set weight_codec=int8 ...``).

``--growth JSON`` (a ``GrowthSchedule`` dict, given to every worker
too; sync mode only) makes each round carry its growth epoch and holds
the workers at the growth barrier until all of them have grown.

The process exits once all rounds aggregated (plus a short linger so
workers see the done flag), printing one JSON line per aggregation and
then ``fed_coordinator DONE`` (or ``TIMEOUT``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

from repro_torch.fedsvc.coordinator import serve_in_thread
from repro_torch.fedsvc.runtime import RunConfig, make_coordinator_state
from repro_torch.obsv.trace import TRACE


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="Federated weight-aggregation coordinator "
                    "(repro_torch.fedsvc protocol)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7050)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="give up if training has not finished by then")
    ap.add_argument("--linger", type=float, default=3.0,
                    help="seconds to keep serving after done, so every "
                         "worker observes the done flag")
    ap.add_argument("--out", default=None,
                    help="write the aggregation history as JSON here")
    RunConfig.add_args(ap)
    args = ap.parse_args(argv)

    cfg = RunConfig.from_args(args)
    strategy = cfg.build_strategy()
    t0 = time.perf_counter()
    state = make_coordinator_state(cfg, device=args.device)
    handle = serve_in_thread(state, host=args.host, port=args.port)
    TRACE.set_process(f"fed_coordinator:{handle.port}")
    print(f"fed_coordinator listening on {handle.host}:{handle.port} "
          f"(mode={strategy.aggregation}, clients={cfg.num_clients}, "
          f"rounds={cfg.rounds}, weight_codec={strategy.weight_codec}, "
          f"sample_frac={strategy.sample_frac}, device {args.device}, "
          f"setup {time.perf_counter() - t0:.3f} s)", flush=True)
    try:
        finished = handle.join(timeout=args.timeout)
        with state.cond:
            history = list(state.history)
        for h in history:
            print(json.dumps(h), flush=True)
        if args.out:
            out = pathlib.Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(history, indent=1))
        print("fed_coordinator " + ("DONE" if finished else "TIMEOUT"),
              flush=True)
        time.sleep(args.linger)
    except KeyboardInterrupt:
        pass
    finally:
        handle.stop()


if __name__ == "__main__":
    main()
