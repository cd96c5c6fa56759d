"""Training launcher: train any zoo architecture on one device.

Counterpart of ``repro/launch/train.py``, with the same flags plus
``--device``: the reduced config of the chosen arch unless
``--full-config``, seeded random parameters, ``make_optimizer``'s
optimizer and ``synthetic_batches``.  As in the JAX launcher, ``--lr`` is
accepted and the optimizer keeps ``make_optimizer``'s rate.  The first
line names the device where the JAX launcher names its mesh.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 20 --batch 8 --seq 128 [--full-config]        # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 2                              # reduced config on the CPU
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.data import synthetic_batches
from repro_torch.launch.steps import make_optimizer
from repro_torch.models import lm
from repro_torch.tree import tree_leaves


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="smollm-360m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full-config", action="store_true",
                    help="use the published config (needs the card)")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    cfg = get_config(args.arch) if args.full_config \
        else get_reduced(args.arch)
    if cfg.family in ("ssm", "hybrid"):
        args.seq = max(args.seq, cfg.ssm_chunk)
        args.seq -= args.seq % cfg.ssm_chunk
    print(f"arch={cfg.name} family={cfg.family} params≈{cfg.param_count():,} "
          f"device={device}")

    params = lm.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    opt = make_optimizer(cfg)
    opt_state = opt.init(tree_leaves(params))
    step = lm.make_train_step(cfg, opt)

    gen = synthetic_batches(cfg, batch=args.batch, seq=args.seq, seed=0,
                            device=device)
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = next(gen)
        params, opt_state, metrics = step(params, opt_state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(metrics['loss']):.4f}  "
                  f"aux {float(metrics['aux']):.4f}  "
                  f"{(time.perf_counter() - t0):.1f}s")
    print("done")


if __name__ == "__main__":
    main()
