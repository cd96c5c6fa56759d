"""The paper's systems ideas on the transformer zoo, on the PyTorch port:
cross-silo federated training with delta pruning + stale aggregation.

Counterpart of ``examples/federated_llm.py`` on ``repro_torch``.  Two
silos train a reduced smollm on disjoint synthetic shards; we compare
  dense  — FedAvg every round (EmbC analogue: ship everything)
  pruned — top-10% magnitude delta sparsification (§4.1 analogue)
  stale  — pruned + one-round-stale aggregation (§4.2 overlap analogue)
and report loss + bytes shipped per round.

Run:  PYTHONPATH=src python examples/federated_llm_torch.py [--device cpu]
"""

import argparse

import torch

from repro_torch.configs import get_reduced
from repro_torch.core.fedopt import FedOptConfig, FederatedLMTrainer
from repro_torch.data import synthetic_batches
from repro_torch.optim import adamw


def stack_silo_batches(cfg, num_silos, local_steps, batch, seq, seed,
                       device):
    """Batches with leading (num_silos, local_steps) dims, one seeded
    stream a silo."""
    gens = [synthetic_batches(cfg, batch=batch, seq=seq, seed=seed + 31 * s,
                              device=device)
            for s in range(num_silos)]
    while True:
        per_silo = [[next(g) for _ in range(local_steps)] for g in gens]
        yield {k: torch.stack([torch.stack([b[k] for b in steps])
                               for steps in per_silo])
               for k in per_silo[0][0]}


def run(name, fed_cfg, *, rounds, batch, seq, device) -> list[float]:
    cfg = get_reduced("smollm-360m")
    tr = FederatedLMTrainer(
        cfg, adamw(2e-3), fed_cfg,
        generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    gen = stack_silo_batches(cfg, fed_cfg.num_silos, fed_cfg.local_steps,
                             batch=batch, seq=seq, seed=0, device=device)
    losses = [tr.round(next(gen))["loss"] for _ in range(rounds)]
    mb = tr.comm_bytes_per_round() / 2**20
    print(f"{name:7s} loss {losses[0]:.3f} -> {losses[-1]:.3f}   "
          f"~{mb:.2f} MiB shipped/round (x{fed_cfg.num_silos} silos)")
    return losses


def main(argv=None) -> dict:
    """Run the three variants; returns {variant: [loss per round]}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    kw = dict(rounds=args.rounds, batch=args.batch, seq=args.seq,
              device=torch.device(args.device))
    steps = args.local_steps
    print(f"federated LLM training, 2 silos x {steps} local steps:")
    out = {
        "dense": run("dense", FedOptConfig(num_silos=2, local_steps=steps),
                     **kw),
        "pruned": run("pruned", FedOptConfig(
            num_silos=2, local_steps=steps, delta_topk_frac=0.10), **kw),
        "stale": run("stale", FedOptConfig(
            num_silos=2, local_steps=steps, delta_topk_frac=0.10,
            stale_aggregation=True), **kw)}
    print("\npruned ships ~10% of the bytes; stale hides the aggregation "
          "behind the next round's compute (one-round staleness, §4.2).")
    return out


if __name__ == "__main__":
    main()
