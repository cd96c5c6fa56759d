"""The port's graph substrate gives byte-identical arrays to
``repro.graphs``: the same preset, scale and seed replay the same numpy
random stream, and partitions and client shards follow."""

import dataclasses

import numpy as np
import pytest

import repro.graphs as jgraphs
import repro_torch.graphs as tgraphs


def _same(a, b, what):
    assert a.dtype == b.dtype, what
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("name,scale", [("arxiv", 0.1), ("reddit", 0.2)])
@pytest.mark.parametrize("seed", [0, 7])
def test_graph_partition_shards_byte_identical(name, scale, seed):
    jg = jgraphs.make_graph(name, scale=scale, seed=seed)
    tg = tgraphs.make_graph(name, scale=scale, seed=seed)
    for f in ("indptr", "indices", "features", "labels", "train_mask"):
        _same(getattr(jg, f), getattr(tg, f), f)
    assert (jg.num_classes, jg.name) == (tg.num_classes, tg.name)

    jp = jgraphs.bfs_partition(jg, 3, seed=seed)
    tp = tgraphs.bfs_partition(tg, 3, seed=seed)
    _same(jp, tp, "partition")

    for limit in (None, 2):
        js = jgraphs.make_client_shards(jg, jp, retention_limit=limit,
                                        seed=seed)
        ts = tgraphs.make_client_shards(tg, tp, retention_limit=limit,
                                        seed=seed)
        assert len(js) == len(ts)
        for a, b in zip(js, ts):
            for f in dataclasses.fields(a):
                va, vb = getattr(a, f.name), getattr(b, f.name)
                if isinstance(va, np.ndarray):
                    _same(va, vb, f"shard {a.client_id} {f.name}")
                else:
                    assert va == vb, f.name


def test_from_edges_matches():
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, 50, 400), rng.integers(0, 50, 400)
    for sym in (True, False):
        a = jgraphs.from_edges(50, src, dst, symmetric=sym)
        b = tgraphs.from_edges(50, src, dst, symmetric=sym)
        _same(a.indptr, b.indptr, "indptr")
        _same(a.indices, b.indices, "indices")


def _shards_equal(js, ts):
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, np.ndarray):
                _same(va, vb, f"shard {a.client_id} {f.name}")
            else:
                assert va == vb, f.name


@pytest.mark.parametrize("name,scale", [("arxiv", 0.1), ("reddit", 0.2)])
@pytest.mark.parametrize("seed", [0, 7])
def test_sampler_minibatches_byte_identical(name, scale, seed):
    """Two epochs of every client's sampler: each Block array, the seeds,
    input ids and remote slots used."""
    from repro.graphs.sampler import NeighborSampler as JSampler

    g = jgraphs.make_graph(name, scale=scale, seed=seed)
    part = jgraphs.bfs_partition(g, 2, seed=seed)
    for sh in jgraphs.make_client_shards(g, part, retention_limit=4,
                                         seed=seed):
        js = JSampler(sh, 5, 3, 32, seed=seed)
        ts = tgraphs.NeighborSampler(sh, 5, 3, 32, seed=seed)
        assert ts.num_batches() == js.num_batches()
        for _ in range(2):
            for a, b in zip(js.epoch(), ts.epoch(), strict=True):
                for f in ("seeds", "seed_mask", "input_ids"):
                    _same(getattr(a, f), getattr(b, f), f)
                assert len(a.remote_slots_used) == len(b.remote_slots_used)
                for ua, ub in zip(a.remote_slots_used, b.remote_slots_used):
                    _same(ua, ub, "remote_slots_used")
                for ba, bb in zip(a.blocks, b.blocks, strict=True):
                    for f in dataclasses.fields(ba):
                        va, vb = getattr(ba, f.name), getattr(bb, f.name)
                        if isinstance(va, np.ndarray):
                            _same(va, vb, f.name)
                        else:
                            assert va == vb, f.name


def test_scored_shards_and_scores_identical():
    """Retention P_4 then a retained-remote filter (as OPG builds its
    shards), and the three remote-node scores on the result."""
    from repro.core import pruning as jpruning
    from repro_torch.core import pruning as tpruning

    g = jgraphs.make_graph("reddit", scale=0.2, seed=3)
    part = jgraphs.bfs_partition(g, 3, seed=3)
    tg = tgraphs.make_graph("reddit", scale=0.2, seed=3)
    base = jgraphs.make_client_shards(g, part, retention_limit=4, seed=3)
    retained = {sh.client_id: sh.pull_nodes[::3] for sh in base}
    js = jgraphs.make_client_shards(g, part, retention_limit=4,
                                    retained_remote=retained, seed=3)
    ts = tgraphs.make_client_shards(tg, part, retention_limit=4,
                                    retained_remote=retained, seed=3)
    _shards_equal(js, ts)
    assert all(len(a.pull_nodes) < len(b.pull_nodes)
               for a, b in zip(js, base))
    for sh in js:
        for kind in ("frequency", "degree", "bridge"):
            _same(jpruning.score_remote_nodes(sh, kind, 3),
                  tpruning.score_remote_nodes(sh, kind, 3), kind)


@pytest.mark.parametrize("limit,seed", [(None, 0), (0, 0), (1, 0), (3, 0),
                                        (4, 9)])
def test_retention_pruned_sets_identical(limit, seed):
    """``retention_pruned_sets`` (P_inf, P_0 and three limits) gives the
    JAX package's per-client sets."""
    from repro.core.pruning import retention_pruned_sets as jsets
    from repro_torch.core.pruning import retention_pruned_sets as tsets

    g = jgraphs.make_graph("arxiv", scale=0.15, seed=7)
    tg = tgraphs.make_graph("arxiv", scale=0.15, seed=7)
    part = jgraphs.bfs_partition(g, 4, seed=0)
    want, got = jsets(g, part, limit, seed=seed), tsets(tg, part, limit,
                                                       seed=seed)
    if limit is None:
        assert want is None and got is None
        return
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for c in want:
        _same(got[c], want[c], f"client {c}")
    if limit:
        assert any(len(v) for v in got.values())


def test_induced_subgraph_identical():
    g = jgraphs.make_graph("reddit", scale=0.2, seed=3)
    tg = tgraphs.make_graph("reddit", scale=0.2, seed=3)
    nodes = np.random.default_rng(1).choice(g.num_vertices, 120,
                                            replace=False)
    (js, jids), (ts, tids) = jgraphs.induced_subgraph(g, nodes), \
        tgraphs.induced_subgraph(tg, nodes)
    _same(tids, jids, "global ids")
    for f in ("indptr", "indices", "features", "labels", "train_mask"):
        _same(getattr(ts, f), getattr(js, f), f)
    assert (ts.num_classes, ts.name) == (js.num_classes, js.name)
    assert ts.num_edges > 0
