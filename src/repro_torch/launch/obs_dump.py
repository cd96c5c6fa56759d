"""obs_dump: scrape every endpoint of a deployment into one timeline.

Port of ``repro/launch/obs_dump.py``.  Every TCP plane answers the shared
telemetry opcodes (:mod:`repro_torch.obsv.teleserve`): embed shards on
their data port, the fedsvc coordinator on its control port, and
fed_worker processes on the telemetry-only listener ``--obs-port``
starts.  The JSON layout is the JAX package's, so one scrape takes any
mix of port and JAX endpoints.  This CLI scrapes them all, aligns each
process's private ``perf_counter`` clock via the scrape-time handshake,
and writes

  * one Chrome trace-event JSON (``--out``) — open it in Perfetto
    (https://ui.perfetto.dev) or ``chrome://tracing``, and
  * one merged metrics table (``--metrics-out``, ``-`` = stdout).

Example, against a 5-process deployment::

    python -m repro_torch.launch.obs_dump \\
        --coordinator 127.0.0.1:7050 \\
        --embed 127.0.0.1:7040 --embed 127.0.0.1:7041 \\
        --worker 127.0.0.1:7060 --worker 127.0.0.1:7061 \\
        --out trace.json --metrics-out -

Spans only appear when the scraped process has tracing on — launch it
with ``REPRO_TRACE=1``.  Metrics are always on.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obsv import teleserve


def collect_endpoints(args) -> list[tuple[str, str]]:
    """→ [(label, addr)] in a stable scrape order."""
    out: list[tuple[str, str]] = []
    if args.coordinator:
        out.append(("coordinator", args.coordinator))
    for i, a in enumerate(args.embed or []):
        out.append((f"embed{i}", a))
    for i, a in enumerate(args.worker or []):
        out.append((f"worker{i}", a))
    if args.serve:
        out.append(("serve", args.serve))
    for spec in args.endpoint or []:
        label, _, addr = spec.partition("=")
        if not addr:
            label, addr = spec, spec
        out.append((label, addr))
    return out


def dump(endpoints: list[tuple[str, object]]) -> tuple[dict, str]:
    """Scrape ``[(label, addr)]`` → (chrome trace doc, metrics table)."""
    return teleserve.merge_scrapes(teleserve.scrape_all(endpoints))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="Scrape OP_METRICS/OP_TRACE from every endpoint of "
                    "a deployment; merge into one Chrome trace + one "
                    "metrics table")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    ap.add_argument("--embed", action="append", metavar="HOST:PORT",
                    help="embed-server shard (repeatable)")
    ap.add_argument("--worker", action="append", metavar="HOST:PORT",
                    help="fed_worker --obs-port listener (repeatable)")
    ap.add_argument("--serve", default=None, metavar="HOST:PORT",
                    help="gnnserve scoring frontend (a JAX endpoint)")
    ap.add_argument("--endpoint", action="append",
                    metavar="LABEL=HOST:PORT",
                    help="any other telemetry-speaking endpoint "
                         "(repeatable)")
    ap.add_argument("--out", default="trace.json",
                    help="Chrome trace-event JSON output path")
    ap.add_argument("--metrics-out", default="-",
                    help="metrics table output path ('-' = stdout)")
    args = ap.parse_args(argv)

    endpoints = collect_endpoints(args)
    if not endpoints:
        ap.error("no endpoints given")
    trace_doc, table = dump(endpoints)
    with open(args.out, "w") as f:
        json.dump(trace_doc, f)
    n_ev = sum(1 for e in trace_doc["traceEvents"] if e["ph"] == "X")
    n_proc = sum(1 for e in trace_doc["traceEvents"] if e["ph"] == "M")
    print(f"obs_dump: {len(endpoints)} endpoints scraped, {n_proc} "
          f"process tracks, {n_ev} spans → {args.out}", flush=True)
    if args.metrics_out == "-":
        sys.stdout.write(table + "\n")
    else:
        with open(args.metrics_out, "w") as f:
            f.write(table + "\n")


if __name__ == "__main__":
    main()
