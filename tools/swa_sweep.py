#!/usr/bin/env python3
"""Sweep the decode attention kernel's cluster size and warps per block on
one GPU, at the LM path's shape and at a batch of one.

    python3 tools/swa_sweep.py [--clusters 1,2,4,8,16] [--warps 1,2,4]

For each batch (8 lanes, the serving path's; 1, long_500k's own) and each
(cluster, warps) pair, set through ``swa_attention``'s CLUSTER,
MAX_CLUSTER and WARPS, it holds ``swa_attention_decode`` on bf16 inputs of
8192 slots, 5 kv heads, G 3, dh 64, window 8192 (``chip_smoke.py``'s
``swa_inputs``) to one bf16 step of its plain version, then prints one
JSON line: the wrapper's ms per call (CUDA events, mean of 50), the
kernel's device ms (torch.profiler) and the card.  The last line names the
pair with the least device time at the path's batch, and its time at a
batch of one.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clusters", default="1,2,4,8,16")
    ap.add_argument("--warps", default="1,2,4")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import swa_attention as swa

    if not torch.cuda.is_available():
        print("swa_sweep: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    dev_ms: dict[tuple[int, int, int], float] = {}
    for B in (cs.LM_LANES, 1):
        inputs = cs.swa_inputs(torch, np, B, 8192, 5, 3, 64, 8, torch.bfloat16,
                               at_head=True)
        want = ref.swa_attention_decode(*inputs, 8192).float()
        for c in (int(x) for x in args.clusters.split(",")):
            for w in (int(x) for x in args.warps.split(",")):
                swa.CLUSTER = swa.MAX_CLUSTER = c
                swa.WARPS = w

                def run():
                    return ops.swa_attention_decode(*inputs, window=8192)
                got = run().float()
                over = float(((got - want).abs()
                              / (2.0 ** -7 * want.abs() + 1e-5)).max())
                cs.check(over <= 1.0, f"B {B} cluster {c} warps {w}: "
                                      f"{over:.3g} of one bf16 step off")
                cs.check(torch.equal(run(), run()),
                         f"B {B} cluster {c} warps {w}: not deterministic")
                dev = cs.device_ms(torch, run, "swa_decode_kernel")
                row = {"B": B, "cluster": c, "warps": w,
                       "ms": cs.time_ms(torch, run), "device_ms": dev,
                       "bf16_steps_off": over, "card": card}
                print(json.dumps(row), flush=True)
                if dev is not None:
                    dev_ms[(B, c, w)] = dev
    path = {(c, w): t for (B, c, w), t in dev_ms.items() if B > 1}
    best = min(path, key=path.get) if path else None
    print(json.dumps({"best": best, "device_ms": path.get(best),
                      "device_ms_batch_1": dev_ms.get((1, *best))
                      if best else None, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
