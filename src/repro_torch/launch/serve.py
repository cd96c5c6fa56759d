"""Serving launcher: batched decode of any zoo architecture.

Counterpart of ``repro/launch/serve.py``, with the same flags plus
``--device``: the prompt is consumed by teacher-forced decode steps (one
code path, the decode step), then ``--generate`` tokens are decoded
greedily.  The parameters are a seeded random init on the device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --full-config                          # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
      --full-config                          # any family: see list_archs()
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --batch 4 --prompt 32 --generate 32    # reduced config on the CPU
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.data import synthetic_request_stream
from repro_torch.models import lm


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type.upper()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="smollm-360m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--generate", type=int, default=32)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cfg = get_config(args.arch) if args.full_config \
        else get_reduced(args.arch)
    params = lm.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    capacity = args.prompt + args.generate
    if cfg.sliding_window:
        capacity = min(capacity, cfg.sliding_window)
    cache = lm.init_cache(cfg, args.batch, capacity, device=device)
    dec = lm.make_serve_step(cfg)

    prompts = torch.from_numpy(next(synthetic_request_stream(
        cfg, batch=args.batch, prompt_len=args.prompt, seed=0))).to(device)
    toks = prompts[:, :1]

    t0 = time.perf_counter()
    generated = []
    for step in range(args.prompt + args.generate - 1):
        logits, cache = dec(params, toks, cache)
        if step < args.prompt - 1:           # teacher-force the prompt
            toks = prompts[:, step + 1: step + 2]
        else:                                # greedy generation
            toks = torch.argmax(logits, dim=-1)
            generated.append(toks[:, 0].cpu().numpy())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    n_tok = args.batch * (args.prompt + args.generate - 1)
    print(f"arch={cfg.name} served {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s on {device_name(device)})")
    gen = np.stack(generated, axis=1)
    print("sample generations (token ids):")
    for row in gen[: min(2, args.batch)]:
        print("  ", row[:16].tolist())


if __name__ == "__main__":
    main()
