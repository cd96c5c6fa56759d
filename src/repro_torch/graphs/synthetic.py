"""Synthetic graph generators calibrated to the paper's Table 1 (copy of
``repro/graphs/synthetic.py``: the same ``(name, scale, seed)`` replays the
same numpy random stream and gives byte-identical arrays).

The container is offline, so OGB downloads are unavailable.  We generate
degree-corrected stochastic-block-model (DC-SBM) graphs whose *relative*
statistics mirror the four evaluation graphs (density ordering, class
counts, train fraction), scaled down to a CPU budget.  Labels are the SBM
blocks and features are noisy label projections, so that neighbourhood
aggregation — including across partition boundaries — carries real signal:
this is the property that makes the paper's D-vs-E accuracy gap
reproducible (§5.3, Fig. 6).
"""

from __future__ import annotations

import numpy as np

from .graph import Graph, from_edges

# name: (vertices, avg_degree, classes, feat_dim, train_frac, homophily,
#        feature_noise).  Degree ordering mirrors Table 1:
# reddit ≫ products > papers > arxiv.  feature_noise is calibrated so the
# paper's D-vs-E accuracy ordering reproduces (dense graphs depend on
# cross-client neighbourhoods; see EXPERIMENTS.md §Repro).
PRESETS: dict[str, tuple[int, float, int, int, float, float, float]] = {
    "arxiv": (6_000, 7.0, 40, 64, 0.54, 0.82, 1.5),
    "reddit": (4_000, 120.0, 41, 96, 0.66, 0.90, 3.0),
    "products": (10_000, 50.0, 47, 64, 0.08, 0.85, 2.0),
    "papers": (20_000, 14.0, 64, 64, 0.011, 0.80, 2.0),
}


def make_graph(
    name: str,
    *,
    seed: int = 0,
    scale: float = 1.0,
    feature_noise: float | None = None,
) -> Graph:
    """Generate a DC-SBM graph for one of the presets (or a custom tuple).

    ``scale`` multiplies the vertex count (degree is preserved) so tests
    can run tiny instances of the same family.
    """
    if name not in PRESETS:
        raise KeyError(f"unknown synthetic graph {name!r}; options {list(PRESETS)}")
    n_v, avg_deg, n_cls, feat_dim, train_frac, homophily, preset_noise = \
        PRESETS[name]
    if feature_noise is None:
        feature_noise = preset_noise
    n_v = max(4 * n_cls, int(n_v * scale))
    rng = np.random.default_rng(seed)

    labels = rng.integers(0, n_cls, size=n_v).astype(np.int32)
    # Degree correction: lognormal weights give a heavy-ish tail like
    # real social/citation graphs.
    theta = rng.lognormal(mean=0.0, sigma=0.9, size=n_v)
    theta /= theta.mean()

    n_e = int(n_v * avg_deg / 2)  # undirected edge count before symmetrize
    # Sample endpoints proportional to theta; route `homophily` fraction
    # within the same block.
    p = theta / theta.sum()
    src = rng.choice(n_v, size=n_e, p=p)
    same = rng.random(n_e) < homophily
    dst = np.empty(n_e, dtype=np.int64)
    # Cross-block edges: uniform theta-weighted endpoint.
    dst[~same] = rng.choice(n_v, size=int((~same).sum()), p=p)
    # Same-block edges: pick theta-weighted endpoint within src's block.
    order = np.argsort(labels, kind="stable")
    block_start = np.searchsorted(labels[order], np.arange(n_cls))
    block_end = np.searchsorted(labels[order], np.arange(n_cls), side="right")
    for c in np.unique(labels[src[same]]):
        members = order[block_start[c]: block_end[c]]
        pc = theta[members] / theta[members].sum()
        sel = same & (labels[src] == c)
        dst[sel] = rng.choice(members, size=int(sel.sum()), p=pc)

    # Features: one-hot label signal projected to feat_dim + Gaussian noise.
    proj = rng.standard_normal((n_cls, feat_dim)).astype(np.float32)
    feats = proj[labels] + feature_noise * rng.standard_normal(
        (n_v, feat_dim)).astype(np.float32)

    train_mask = rng.random(n_v) < train_frac
    train_mask[: n_cls] = True  # every class has at least one train vertex

    g = from_edges(
        n_v, src, dst, symmetric=True, dedup=True,
        features=feats.astype(np.float32), labels=labels,
        train_mask=train_mask, num_classes=n_cls, name=name,
    )
    g.validate()
    return g
