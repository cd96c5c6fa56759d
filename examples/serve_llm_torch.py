"""Batched serving over the architecture zoo on the PyTorch port.

Counterpart of ``examples/serve_llm.py`` on ``repro_torch``: it serves
three families (GQA dense, SSM, MLA+MoE) at their reduced configs with
batched requests through the decode step (the prompt teacher-forced,
then greedy tokens), and prints tokens/s.  The parameters are a seeded
random init on the device.

Run:  PYTHONPATH=src python examples/serve_llm_torch.py [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.configs import get_reduced
from repro_torch.data import synthetic_request_stream
from repro_torch.models import lm

ARCHS = ("smollm-360m", "mamba2-1.3b", "deepseek-v2-lite-16b")


def serve(arch, device, batch=4, prompt=16, generate=16) -> float:
    """Serve one batch of ``arch``; prints and returns its tokens/s."""
    cfg = get_reduced(arch)
    params = lm.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    cache = lm.init_cache(cfg, batch, prompt + generate, device=device)
    prompts = torch.from_numpy(next(synthetic_request_stream(
        cfg, batch=batch, prompt_len=prompt, seed=0))).to(device)
    toks = prompts[:, :1]
    logits = None
    t0 = time.perf_counter()
    with torch.no_grad():
        for step in range(prompt + generate - 1):
            logits, cache = lm.decode_step(params, cfg, toks, cache)
            toks = prompts[:, step + 1: step + 2] if step < prompt - 1 \
                else torch.argmax(logits, dim=-1)
    if not bool(torch.isfinite(logits.float()).all()):
        raise RuntimeError(f"{arch}: non-finite logits")
    dt = time.perf_counter() - t0          # the isfinite read synchronized
    n = batch * (prompt + generate - 1)
    print(f"  {arch:24s} ({cfg.family:6s}) {n / dt:7.1f} tok/s")
    return n / dt


def main(argv=None) -> dict:
    """Serve each family; returns {arch: tokens/s}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--generate", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "CPU"
    print(f"batched serving across families ({where}, reduced configs):")
    return {arch: serve(arch, device, args.batch, args.prompt,
                        args.generate) for arch in ARCHS}


if __name__ == "__main__":
    main()
