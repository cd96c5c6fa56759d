#!/usr/bin/env python3
"""Time the port's GNN training step on one GPU for two source trees, in
turns, so that a change is compared with its parent on one card.

    python3 tools/train_step_ab.py PARENT_ROOT CHANGE_ROOT [--rounds 2]

Each run is a process of its own that imports ``repro_torch`` from
``<root>/src``; the runs go parent, change, change, parent (``--rounds``
times the pair, mirrored).  A run builds ``chip_smoke.py``'s training
configuration (the reddit preset at scale 58, 4 clients by
``bfs_partition``, Strategy OPG with int8 and degree scores, GraphConv
L = 3 hidden 32 from a seeded init, Adam), bootstraps, fills client 0's
cache and trains client 0 for ``--warmup`` + ``--steps`` minibatches
through ``train_minibatches``.  Forward + backward + Adam of a step is
measured as ``chip_smoke.py`` measures ``fwd_bwd_adam_ms``: from a CUDA
event recorded after the block copy (the device synchronised) to one
recorded after the step; the block copy (``blocks_to_arrays`` to that
synchronise) on the host's clock.  Then the trained state is exported
for serving (``export_for_serving``: every shard's arrays built and
copied, a full propagate and a push), timed to a synchronise, and
served as ``chip_smoke.py`` serves (cache of 100,000 rows, fanout 10,
batches of 64, depths 1 and 3): 256 Zipf queries to warm up, then a
drained burst of 2048 (half at threshold 1.0, half at 0.5), whose
queries/s is reported.  Last, client 0's engine at each of depths 1 and
3: 136 whole forwards of 64 seeds (``_forward_unique``: the plan, the
blocks' build and copy, the layers and the logits' read-back) and, for
136 more plans, the ``_batch_arrays`` call alone (the blocks built and
copied to the card, timed to a synchronise); the first 8 of each are
left out.  Each run
prints one ``result:`` JSON line; the last line is a summary with every
run's p50s, export seconds and queries/s in order.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time


def child(steps: int, warmup: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import federated as fed
    from repro_torch.core.strategies import default_strategies
    from repro_torch.gnnserve import build_serving
    from repro_torch.graphs import bfs_partition, make_graph
    from repro_torch.kernels import _build, ops
    from repro_torch.models.gnn import init_gnn

    if not torch.cuda.is_available():
        raise SystemExit("train_step_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    g = make_graph("reddit", scale=58.0, seed=0)
    part = bfs_partition(g, 4, seed=0)
    st = dataclasses.replace(default_strategies()["OPG"], codec="int8",
                             score_kind="degree")
    model = init_gnn("graphconv", g.feat_dim, 32, g.num_classes, 3,
                     generator=torch.Generator().manual_seed(0),
                     device="cuda")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = fed.FederatedGNNTrainer(g, 4, st, part=part, model=model,
                                      device="cuda")
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    construct_launches = {k: v for k, v in ops.launch_counts().items() if v}
    trainer.pretrain_round()
    trainer._fill_cache(0)
    torch.cuda.synchronize()

    it = trainer.samplers[0].epoch()
    params = copy.deepcopy(trainer.model)
    opt_state = trainer.opt.init(params.leaves())
    copied: list = []
    copy_ms: list = []
    inner = fed.blocks_to_arrays

    def copy_blocks(mb, device):
        t = time.perf_counter()
        out = inner(mb, device)
        torch.cuda.synchronize()
        copy_ms.append((time.perf_counter() - t) * 1e3)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        copied.append(ev)
        return out

    compute_ms = []
    fed.blocks_to_arrays = copy_blocks
    try:
        ops.reset_launch_counts()
        for i in range(warmup + steps):
            mb = next(it)
            params, opt_state, _ = trainer.train_minibatches(
                0, params, opt_state, [mb])
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            if i >= warmup:
                compute_ms.append(copied[-1].elapsed_time(end))
    finally:
        fed.blocks_to_arrays = inner
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle = trainer.export_for_serving()
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    plane = build_serving(bundle, cache_rows=100_000, serve_fanout=10,
                          batch_size=64, depth_schedule=[1, 3],
                          device="cuda")
    rng = np.random.default_rng(11)
    perm = rng.permutation(g.num_vertices)
    vids = perm[(rng.zipf(1.2, 256 + 2048) - 1) % g.num_vertices]
    for burst in (vids[:256], vids[256:]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, v in enumerate(burst):
            plane.submit(int(v), 1.0 if i % 2 == 0 else 0.5)
        plane.drain()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0

    eng = plane.engines[0]
    seed_rng = np.random.default_rng(12)
    batch_ms: dict[int, list] = {}
    forward_ms: dict[int, list] = {}
    for depth in (1, 3):
        ms = forward_ms[depth] = []
        for i in range(8 + 128):
            seeds = np.sort(seed_rng.choice(eng.shard.num_local, 64,
                                            replace=False))
            t0 = time.perf_counter()
            eng._forward_unique(seeds, depth)
            if i >= 8:
                ms.append((time.perf_counter() - t0) * 1e3)
        ms = batch_ms[depth] = []
        for i in range(8 + 128):
            seeds = np.sort(seed_rng.choice(eng.shard.num_local, 64,
                                            replace=False))
            plan = eng._plan(seeds, depth)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._batch_arrays(plan)
            torch.cuda.synchronize()
            if i >= 8:
                ms.append((time.perf_counter() - t0) * 1e3)

    def stats(xs):
        a = np.asarray(xs, np.float64)
        return {"p50": float(np.percentile(a, 50)),
                "p99": float(np.percentile(a, 99)), "mean": float(a.mean())}
    return {
        "card": torch.cuda.get_device_name(0),
        "steps": steps,
        "fwd_bwd_adam_ms": stats(compute_ms),
        "copy_ms": stats(copy_ms[warmup:]),
        "export_s": export_s,
        "queries_per_s": 2048 / serve_s,
        "serve_batch_arrays_ms": {f"depth{d}": stats(v)
                                  for d, v in batch_ms.items()},
        "serve_forward_ms": {f"depth{d}": stats(v)
                             for d, v in forward_ms.items()},
        "construct_s": construct_s,
        "construct_launches": construct_launches,
        "step_launches_per_step": {k: v / (warmup + steps) for k, v in
                                   ops.launch_counts().items() if v},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="PARENT_ROOT CHANGE_ROOT")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print("result: " + json.dumps(child(args.steps, args.warmup)),
              flush=True)
        return 0
    if len(args.trees) != 2:
        ap.error("give two source trees: PARENT_ROOT CHANGE_ROOT")
    names = ("parent", "change")
    order = [0, 1, 1, 0] * args.rounds
    runs = []
    for i in order:
        root = pathlib.Path(args.trees[i]).resolve()
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        out = subprocess.run(
            [sys.executable, __file__, "--child", "--steps",
             str(args.steps), "--warmup", str(args.warmup)],
            env=env, cwd=root, capture_output=True, text=True, check=False)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("result: ")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"train_step_ab: the {names[i]} run failed")
        res = json.loads(lines[-1][len("result: "):])
        res["tree"] = names[i]
        print(f"{names[i]}: {json.dumps(res)}", flush=True)
        runs.append(res)
    print(json.dumps({
        "fwd_bwd_adam_p50_ms": [(r["tree"], r["fwd_bwd_adam_ms"]["p50"])
                                for r in runs],
        "copy_p50_ms": [(r["tree"], r.get("copy_ms", {}).get("p50"))
                        for r in runs],
        "export_s": [(r["tree"], r.get("export_s")) for r in runs],
        "queries_per_s": [(r["tree"], r.get("queries_per_s"))
                          for r in runs],
        "serve_forward_p50_ms": [
            (r["tree"], {k: v["p50"] for k, v in
                         r["serve_forward_ms"].items()})
            for r in runs],
        "serve_batch_arrays_p50_ms": [
            (r["tree"], {k: v["p50"] for k, v in
                         r["serve_batch_arrays_ms"].items()})
            for r in runs]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
