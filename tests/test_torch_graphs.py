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
