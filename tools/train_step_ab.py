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
recorded after the step.  Each run prints one ``result:`` JSON line; the
last line is a summary with every run's p50 in order.
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
    inner = fed.blocks_to_arrays

    def copy_blocks(mb, device):
        out = inner(mb, device)
        torch.cuda.synchronize()
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
    a = np.asarray(compute_ms, np.float64)
    return {
        "card": torch.cuda.get_device_name(0),
        "steps": steps,
        "fwd_bwd_adam_ms": {"p50": float(np.percentile(a, 50)),
                            "p99": float(np.percentile(a, 99)),
                            "mean": float(a.mean())},
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
    print(json.dumps({"fwd_bwd_adam_p50_ms": [
        (r["tree"], r["fwd_bwd_adam_ms"]["p50"]) for r in runs]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
