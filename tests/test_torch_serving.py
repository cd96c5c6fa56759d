"""The port's slice as a whole, held to the JAX package: publish the
trained state into the embedding server, then serve vertex queries
through the batched early-exit plane.

The JAX trainer (arxiv at scale 0.1, 2 clients, GraphConv L=3 hidden 16,
Strategy E) runs its bootstrap push and one round; its parameters and
its server's rows then start both sides from the same state.

Publish: with the fp32 codec the tables agree within 1e-5.  With int8
they agree within one quantization step per element, and at least 99% of
rows carry identical int8 codes: the two frameworks' float32 products sum
in different orders, and a one-ulp difference can flip one rounding.  A
row's fp32 scale is its absmax · fp32(1/127), so an ulp in the absmax
moves every decoded value of the row; the scales are held to a relative
1e-6 instead of bit equality.

Serve: over the same query stream the answers agree per request —
predictions equal, confidences within 1e-4, exit depths equal except
where a confidence lies within 1e-4 of its threshold — and so do
``offline_predict`` and the cache's hit, miss and eviction counts.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import FederatedGNNTrainer, Strategy
from repro.gnnserve import build_serving as jbuild_serving
from repro.graphs import make_graph as jmake_graph
from repro_torch.core.federated import export_for_serving, setup_exchange
from repro_torch.exchange import make_transport
from repro_torch.gnnserve import build_serving as tbuild_serving
from repro_torch.graphs import make_client_shards, make_graph
from repro_torch.models.gnn import from_jax_leaves

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")
torch.set_num_threads(1)

L, HIDDEN = 3, 16
CONF_TOL = 1e-4


def _trainer(codec):
    g = jmake_graph("arxiv", scale=0.1, seed=7)
    tr = FederatedGNNTrainer(g, 2, dataclasses.replace(Strategy("E"),
                                                       codec=codec),
                             num_layers=L, hidden=HIDDEN, fanout=4,
                             batch_size=16, seed=0)
    tr.pretrain_round()
    tr.run_round(0, 0.0)
    return tr


@pytest.fixture(scope="module")
def trainers():
    return {codec: _trainer(codec) for codec in ("fp32", "int8")}


def _snapshot(server):
    gids = np.nonzero(server._gid2row >= 0)[0]
    rows = server._gid2row[gids]
    return gids, server._ver[rows].copy(), \
        [np.asarray(b)[rows, : server.hidden] for b in server._bufs]


def _port_side(tr, snapshot, codec):
    """The port's model, shards and a transport loaded from ``snapshot``."""
    g = make_graph("arxiv", scale=0.1, seed=7)
    shards = make_client_shards(g, tr.part)
    tt = make_transport(L, HIDDEN, device="cpu")
    tt.server.load_rows(*snapshot)
    setup_exchange(shards, tr.part, tt)
    model = from_jax_leaves(tr.params_leaves(), "graphconv", device="cpu")
    return model, shards, tt


@pytest.mark.parametrize("codec", ["fp32", "int8"])
def test_publish_matches_jax(trainers, codec):
    tr = trainers[codec]
    model, shards, tt = _port_side(tr, _snapshot(tr.exchange.server), codec)
    for a, b in zip(shards, tr.shards):
        np.testing.assert_array_equal(a.push_nodes, b.push_nodes)
    bundle = export_for_serving(model, shards, tr.part, tt, codec,
                                device="cpu")
    tr.export_for_serving()
    gids = np.arange(tr.g.num_vertices)
    np.testing.assert_array_equal(tt.server.versions(gids),
                                  tr.exchange.server.versions(gids))
    assert bundle["num_layers"] == L and bundle["hidden"] == HIDDEN
    assert sorted(bundle["shards"]) == [0, 1]
    for want, got in zip(tr.exchange.gather(gids), tt.gather(gids)):
        want, got = np.asarray(want), got.numpy()
        if codec == "fp32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            continue
        sw = np.abs(want).max(axis=1, keepdims=True) / 127.0
        sg = np.abs(got).max(axis=1, keepdims=True) / 127.0
        assert np.all(np.abs(got - want) <= sw * (1 + 1e-6) + 1e-12)
        np.testing.assert_allclose(sg, sw, rtol=1e-6, atol=0)
        codes_w = np.rint(want / np.where(sw > 0, sw, 1))
        codes_g = np.rint(got / np.where(sg > 0, sg, 1))
        same = np.all(codes_g == codes_w, axis=1).mean()
        assert same >= 0.99, f"only {same:.4f} of rows share their codes"


def _drain(plane, vids, thrs):
    rids = [plane.submit(int(v), float(t)) for v, t in zip(vids, thrs)]
    out = {r.rid: r for r in plane.drain()}
    assert sorted(out) == sorted(rids)
    return out


def test_serving_matches_jax(trainers):
    tr = trainers["int8"]
    jbundle = tr.export_for_serving()
    model, shards, tt = _port_side(tr, _snapshot(tr.exchange.server), "int8")
    tbundle = {"model": model, "conv": "graphconv", "num_layers": L,
               "hidden": HIDDEN, "part": np.asarray(tr.part),
               "shards": {sh.client_id: sh for sh in shards},
               "transport": tt, "codec": "int8"}
    kw = dict(cache_rows=64, serve_fanout=5, batch_size=16,
              depth_schedule=[1, 2, 3])
    jplane = jbuild_serving(jbundle, **kw)
    tplane = tbuild_serving(tbundle, device="cpu", **kw)

    rng = np.random.default_rng(5)
    vids = rng.integers(0, tr.g.num_vertices, 120)
    thrs = rng.choice([1.0, 0.6, 0.3], size=len(vids))
    jres, tres = _drain(jplane, vids, thrs), _drain(tplane, vids, thrs)
    depths = {}
    for rid, j in jres.items():
        t = tres[rid]
        assert (t.vid, t.pred) == (j.vid, j.pred), f"rid {rid}"
        assert abs(t.conf - j.conf) <= CONF_TOL, f"rid {rid}"
        if abs(j.conf - thrs[rid]) > CONF_TOL:
            assert t.depth == j.depth, f"rid {rid}"
        depths[j.depth] = depths.get(j.depth, 0) + 1
    assert len(depths) >= 2, f"the stream exercised one depth: {depths}"

    jst, tst = jplane.cache.stats(), tplane.cache.stats()
    for k in ("hits", "misses", "evictions", "stale_refreshes", "rows"):
        assert tst[k] == jst[k], k
    assert tst["evictions"] > 0

    for ci, jeng in jplane.engines.items():
        teng = tplane.engines[ci]
        seeds = np.arange(min(40, jeng.shard.num_local), dtype=np.int64)
        for i in range(0, len(seeds), 16):
            np.testing.assert_array_equal(
                teng.offline_predict(seeds[i: i + 16]),
                jeng.offline_predict(seeds[i: i + 16]))


def test_batcher_drain_and_cache_reset_match_jax(trainers):
    """``QueryBatcher.run_to_completion`` / ``pop_completed`` and
    ``HotEmbeddingCache.reset_stats`` on one shard's batcher of each
    plane, over the same query stream: the same retired requests in the
    same order, the same completed record, and counters zeroed with the
    cached rows kept, as in JAX."""
    tr = trainers["fp32"]
    jbundle = tr.export_for_serving()
    model, shards, tt = _port_side(tr, _snapshot(tr.exchange.server), "fp32")
    tbundle = {"model": model, "conv": "graphconv", "num_layers": L,
               "hidden": HIDDEN, "part": np.asarray(tr.part),
               "shards": {sh.client_id: sh for sh in shards},
               "transport": tt, "codec": "fp32"}
    kw = dict(cache_rows=64, serve_fanout=5, batch_size=16,
              depth_schedule=[1, 3])
    jplane = jbuild_serving(jbundle, **kw)
    tplane = tbuild_serving(tbundle, device="cpu", **kw)
    vids = np.nonzero(np.asarray(tr.part) == 0)[0][::7][:40]
    thrs = np.random.default_rng(2).choice([1.0, 0.5], size=len(vids))
    out = []
    for plane in (jplane, tplane):
        b = plane.batchers[0]
        for v, t in zip(vids, thrs):
            b.submit(int(v), float(t))
        done = b.run_to_completion()
        assert b.pending() == 0 and len(done) == len(vids)
        popped = b.pop_completed()
        assert [r.rid for r in popped] == [r.rid for r in done]
        assert b.pop_completed() == []
        out.append([(r.rid, r.vid, r.pred, r.depth) for r in done])
    assert out[0] == out[1]
    # the plane pops what it returns: a long-running plane keeps nothing
    rids = [tplane.submit(int(v)) for v in vids[:8]]
    assert sorted(r.rid for r in tplane.drain()) == rids
    assert all(not b.completed for b in tplane.batchers.values())
    for plane in (jplane, tplane):
        rows = plane.cache.stats()["rows"]
        assert rows > 0
        plane.cache.reset_stats()
        st = plane.cache.stats()
        assert st["rows"] == rows and plane.cache.hit_rate == 0.0
        assert st["hits"] == st["misses"] == st["stale_refreshes"] == 0
        assert st["evictions"] == 0 and plane.cache.pull_time == 0.0
    assert tplane.cache.stats() == jplane.cache.stats()
