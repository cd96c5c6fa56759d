"""Readings that set the limits of ``correct``, on the card, in one process
per cell (the benchmark's runs never call it).

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--rounds 1] [--control 3] [--first-round 3] [--faults half,frozen] \\
        --out <file.jsonl>

For each seed it sets the cell up, runs ``--rounds`` rounds of the
window and writes, after each, the gap between the accuracy the round
reports and the reference's evaluation of the model it left, for the
first ``--control`` seeds also the control's (the reference in TF32 in
the program's place) and an altered answer's.  For the first
``--first-round`` seeds it writes the program's first-round numbers
against the plain reference, and where the seed is also among the
first ``--control``, the control's and each planted fault's of
``--faults``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import torch  # noqa: E402

from perfbench import compare, harness  # noqa: E402
from perfbench.drivers import train  # noqa: E402
from perfbench.reference.model import Precision  # noqa: E402

TRAIN_FAULTS = ("half", "frozen", "no_exchange")


def reuse_shards() -> None:
    """The reference builds a seed's shards once in this process (its
    control and faults read the same shards)."""
    from perfbench.reference import federated

    inner = federated.build_shards
    memo: dict = {}

    def build_shards(g, part, strategy, seed):
        key = (id(g), json.dumps(strategy, sort_keys=True), seed)
        if key not in memo:
            memo.clear()
            memo[key] = inner(g, part, strategy, seed)
        return memo[key]

    federated.build_shards = build_shards


def context(workload: str, seed: int, seconds: float) -> harness.Ctx:
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(bench, workload)
    prec = cell.config["precision"]
    torch.backends.cuda.matmul.allow_tf32 = bool(prec["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(prec["tf32"])
    return harness.Ctx(cell, seed, seconds, False, "cuda",
                       harness.Recorder(False))


def window_numbers(ctx, st, **kw) -> float:
    return abs(st.program["window_acc"] - train.window_reference(ctx, st,
                                                                 **kw))


def calibrate_train(args, emit) -> None:
    for n, seed in enumerate(args.seeds):
        ctx = context(args.workload, seed, 0.0)
        t0 = time.perf_counter()
        st = train.setup(ctx)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        for r in range(args.rounds):
            train.window(ctx, st)
            row = {"seed": seed, "who": "program", "round": st.rounds - 1,
                   "window_acc_gap": window_numbers(ctx, st)}
            if n < args.control:
                row["control"] = window_numbers(
                    ctx, st, prec=Precision(tf32=True))
                row["fault:answer"] = window_numbers(ctx, st, fault="answer")
            emit(row)
        train.release(st)
        torch.cuda.empty_cache()
        if n >= args.first_round:
            continue
        t0 = time.perf_counter()
        ref = train.reference(ctx, st)
        norms = ("loss", "grad_norms", "step3_norms", "round_norms", "acc")
        emit({"seed": seed, "who": "program", "setup_s": setup_s,
              "reference_s": time.perf_counter() - t0,
              "numbers": compare.train_numbers(st.program, ref),
              "raw": {k: [st.program[k], ref[k]] for k in norms}})
        if n >= args.control:
            continue
        ctrl = train.reference(ctx, st, prec=Precision(tf32=True))
        emit({"seed": seed, "who": "control",
              "numbers": compare.train_numbers(ctrl, ref)})
        strategy = ctx.cell.workload["strategy"]
        for fault in args.faults:
            if fault == "no_exchange" and not strategy["use_embeddings"]:
                continue
            bad = train.reference(ctx, st, fault=fault)
            emit({"seed": seed, "who": f"fault:{fault}",
                  "numbers": compare.train_numbers(bad, ref)})


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=lambda s: [int(x) for x in s.split(",")],
                   required=True)
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--first-round", type=int, default=0)
    p.add_argument("--faults", type=lambda s: [x for x in s.split(",") if x],
                   default=list(TRAIN_FAULTS))
    p.add_argument("--out", required=True)
    args = p.parse_args()
    reuse_shards()
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)

    def emit(row: dict) -> None:
        row = dict(row, workload=args.workload,
                   card=torch.cuda.get_device_name(0))
        line = json.dumps(row)
        print(line, flush=True)
        with open(out, "a") as f:
            f.write(line + "\n")

    calibrate_train(args, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
