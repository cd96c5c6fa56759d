"""CLI: build an out-of-core graph store + partition + client shards.

Port of ``repro/launch/build_store.py``: the same flags, the same store
files byte for byte and the same JSON stats line.  It imports numpy and
the port's numpy-only ``graphs`` and ``graphstore`` packages, never
torch, so a build costs no CUDA start.

One command takes a graph family to a ready-to-serve store directory:
the mmap CSR lands via the chunked streaming builder (never holding the
edge list), the partition via the single-pass streaming LDG (or the
in-memory BFS partitioner for small graphs), and the per-client shards
via the streaming halo extractor — after which every ``fed_worker``
points at it with ``--graph store:<dir>`` and mmaps only its own
clients' shards.

    # 1M-vertex R-MAT, 8 client shards
    python -m repro_torch.launch.build_store --out STORE_DIR \
        --rmat-scale 20 --edge-factor 8 --seed 1 --clients 8

    # a Table-1 preset, bit-identical to the in-memory generator
    python -m repro_torch.launch.build_store --out STORE_DIR \
        --preset reddit --scale 0.05 --graph-seed 3 --clients 2

Prints one JSON line of build/partition stats (vertices, edges,
throughput, partition sizes, boundary pull nodes, peak RSS), read from
a subprocess so builder RSS is measured in isolation.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np


def _status_kb(field: str) -> float | None:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(field):
                    return float(line.split()[1])
    except OSError:
        pass
    return None


_rss_samples: list[float] = []


def _sample_rss() -> None:
    cur = _status_kb("VmRSS")
    if cur is not None:
        _rss_samples.append(cur)


def _start_rss_sampler(period_s: float = 0.05):
    """Background VmRSS sampler — catches transient peaks (bucket sort
    temporaries) that phase-boundary samples would miss."""
    import threading
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            _sample_rss()
            stop.wait(period_s)

    threading.Thread(target=loop, daemon=True).start()
    return stop


def _peak_rss_mb() -> float:
    """Peak RSS of this process: the kernel's high-water mark when
    exposed, else the max of the per-phase VmRSS samples.  getrusage is
    last resort only — under some sandboxes a fork()ed child *inherits*
    the parent's ru_maxrss, which makes a slim builder spawned from a
    fat benchmark process look enormous."""
    hwm = _status_kb("VmHWM")
    if hwm is not None:
        return hwm / 1024
    if _rss_samples:
        return max(_rss_samples) / 1024
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="Build an mmap graph store (+ partition + shards)")
    ap.add_argument("--out", required=True, help="store directory")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--preset", help="synthetic preset (DC-SBM, "
                                      "bit-identical to make_graph)")
    src.add_argument("--rmat-scale", type=int,
                     help="R-MAT: V = 2**scale (Graph500 kernel 1)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="preset vertex-count multiplier")
    ap.add_argument("--graph-seed", type=int, default=3,
                    help="generator seed (matches RunConfig --graph-seed)")
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0,
                    help="partition seed (matches RunConfig --seed)")
    ap.add_argument("--clients", type=int, default=0,
                    help="partition + build shards for K clients (0: skip)")
    ap.add_argument("--partitioner", choices=("ldg", "bfs"), default="ldg")
    ap.add_argument("--retention", default="inf",
                    help="retention limit baked into the shards "
                         "(int, or 'inf' for P_inf/EmbC)")
    args = ap.parse_args(argv)

    from repro_torch.graphstore import (build_rmat_store, build_sbm_store,
                                        ldg_partition, stream_client_shards)

    _sample_rss()
    _sampler_stop = _start_rss_sampler()
    t0 = time.perf_counter()
    if args.preset is not None:
        store = build_sbm_store(args.out, args.preset, scale=args.scale,
                                seed=args.graph_seed)
    else:
        store = build_rmat_store(args.out, args.rmat_scale,
                                 edge_factor=args.edge_factor,
                                 seed=args.graph_seed)
    t_build = time.perf_counter() - t0
    _sample_rss()
    build_rss_kb = max(_rss_samples, default=0.0)

    stats = {
        "path": store.path,
        "num_vertices": store.num_vertices,
        "num_edges": store.num_edges,
        "build_s": round(t_build, 3),
        "build_edges_per_s": round(store.num_edges / max(t_build, 1e-9)),
        "build_peak_rss_mb": round(build_rss_kb / 1024, 1),
    }

    if args.clients > 0:
        k = args.clients
        t0 = time.perf_counter()
        if args.partitioner == "ldg":
            part = ldg_partition(store, k, seed=args.seed)
        else:
            from repro_torch.graphs import bfs_partition
            part = bfs_partition(store, k, seed=args.seed)
        t_part = time.perf_counter() - t0
        _sample_rss()
        store.save_partition(part, k, args.seed)

        limit = None if args.retention == "inf" else int(args.retention)
        t0 = time.perf_counter()
        # one shard resident at a time: k cheap mmap passes instead of
        # holding every shard's edges — this keeps the whole pipeline's
        # RSS bounded by one shard, not the graph
        pulls: list[np.ndarray] = []
        for c in range(k):
            sh = stream_client_shards(store, part, client_ids=[c],
                                      retention_limit=limit,
                                      seed=args.seed)[0]
            store.save_shard(sh, k, args.seed, limit)
            pulls.append(sh.pull_nodes)
            del sh
        # reciprocal push sets, exactly as the trainer recomputes them:
        # client c pushes what the others retained
        root = store.shards_dir(k, args.seed, limit)
        for c in range(k):
            wanted = [p[part[p] == c]
                      for j, p in enumerate(pulls) if j != c]
            push = np.unique(np.concatenate(wanted)) \
                if wanted else np.zeros(0, np.int64)
            np.save(os.path.join(root, f"shard{c}", "push_nodes.npy"),
                    push)
        store.finalize_shards(k, args.seed, limit, k)
        t_shard = time.perf_counter() - t0
        _sample_rss()

        boundary = int(sum(len(p) for p in pulls))
        sizes = np.bincount(part, minlength=k)
        stats.update({
            "clients": k,
            "partition_s": round(t_part, 3),
            "partition_vertices_per_s":
                round(store.num_vertices / max(t_part, 1e-9)),
            "shard_s": round(t_shard, 3),
            "part_sizes": [int(s) for s in sizes],
            "boundary_pull_nodes": boundary,
        })

    _sampler_stop.set()
    stats["peak_rss_mb"] = round(_peak_rss_mb(), 1)
    json.dump(stats, sys.stdout)
    print(flush=True)


if __name__ == "__main__":
    main()
