"""End-to-end federated GNN training run on the PyTorch port.

Counterpart of ``examples/train_federated_e2e.py`` on ``repro_torch``: a
Products-like graph partitioned onto 4 clients, pre-training bootstrap,
30 federated rounds of 3 local epochs under the EmbC baseline (E) and the
best OptimES strategy (OPG), with per-round accuracy / timing logs, a
final TTA report, and (measured compute + modelled 1 Gbps network) phase
breakdowns.

Run:  PYTHONPATH=src python examples/train_federated_e2e_torch.py \\
          [--rounds N] [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.federated import (FederatedGNNTrainer, peak_accuracy,
                                        time_to_accuracy)
from repro_torch.core.strategies import default_strategies
from repro_torch.graphs import make_graph


def main(argv=None) -> dict:
    """Train E and OPG and print the summary; returns {strategy:
    [RoundStats]}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--conv", choices=("graphconv", "sageconv"),
                    default="graphconv")
    ap.add_argument("--scale", type=float, default=0.4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    graph = make_graph("products", scale=args.scale, seed=1)
    print(f"graph: V={graph.num_vertices} E={graph.num_edges} "
          f"avg_deg={graph.avg_degree():.1f}")

    strategies = default_strategies()
    runs = {}
    for name in ("E", "OPG"):
        print(f"\n=== strategy {name}: {strategies[name].describe()} ===")
        tr = FederatedGNNTrainer(graph, args.clients, strategies[name],
                                 conv=args.conv, batch_size=256, seed=0,
                                 device=args.device)
        runs[name] = tr.train(args.rounds, verbose=True)

    target = min(peak_accuracy(s) for s in runs.values()) - 0.01
    print(f"\n=== summary (target acc {target:.4f}) ===")
    for name, stats in runs.items():
        t = time_to_accuracy(stats, target)
        rt = float(np.median([s.round_time for s in stats]))
        print(f"{name:4s} peak={peak_accuracy(stats):.4f} "
              f"median_round={rt:.2f}s "
              f"TTA={t if t is not None else float('nan'):.1f}s")
    e, o = runs["E"], runs["OPG"]
    te, to = time_to_accuracy(e, target), time_to_accuracy(o, target)
    if te and to:
        print(f"\nOptimES(OPG) reaches target {te / to:.2f}x faster than "
              f"EmbC — the paper reports ≈3.6x for Products (Fig. 6b).")
    return runs


if __name__ == "__main__":
    main()
