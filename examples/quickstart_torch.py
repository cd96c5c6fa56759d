"""Quickstart on the PyTorch port: the paper's headline comparison.

Counterpart of ``examples/quickstart.py`` on ``repro_torch``: it trains a
federated GNN on a dense synthetic (Reddit-like) graph with cross-client
edges under three regimes and prints the Fig. 6a story:

  D    default federated GNN (no embedding exchange)  — fast, low accuracy
  E    EmbC (pull/push all boundary embeddings)       — accurate, slow
  OPP  OptimES (prune + overlap + scored prefetch)    — accurate AND fast

Run:  PYTHONPATH=src python examples/quickstart_torch.py   # on the card
      PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.core.federated import (FederatedGNNTrainer, peak_accuracy,
                                        time_to_accuracy)
from repro_torch.core.strategies import default_strategies
from repro_torch.graphs import make_graph

STRATEGIES = ("D", "E", "OPP")


def main(argv=None) -> dict:
    """Train each strategy and print the table; returns {strategy:
    [RoundStats]}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.3)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    graph = make_graph("reddit", scale=args.scale, seed=3)
    print(f"graph: V={graph.num_vertices} E={graph.num_edges} "
          f"avg_deg={graph.avg_degree():.0f} classes={graph.num_classes}")
    results = {}
    for name in STRATEGIES:
        strat = default_strategies()[name]
        tr = FederatedGNNTrainer(graph, 4, strat, batch_size=128, seed=0,
                                 device=args.device)
        results[name] = tr.train(args.rounds, verbose=False)
        print(f"  trained {name:3s}: {strat.describe()}")

    target = min(peak_accuracy(s) for n, s in results.items()
                 if n != "D") - 0.01
    print(f"\n{'strategy':10s} {'peak acc':>9s} {'median round':>13s} "
          f"{'TTA(@{:.0%})'.format(target):>12s} {'emb stored':>11s}")
    for name, stats in results.items():
        rt = float(np.median([s.round_time for s in stats]))
        t = time_to_accuracy(stats, target, smooth=3)
        print(f"{name:10s} {peak_accuracy(stats):9.4f} {rt:12.3f}s "
              f"{t if t is not None else float('nan'):11.2f}s "
              f"{stats[-1].embeddings_stored:11d}")
    print("\nExpected ordering (paper Fig. 6a): accuracy D < E ≈ OPP; "
          "round time OPP < E.")
    return results


if __name__ == "__main__":
    main()
