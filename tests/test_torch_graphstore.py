"""The port's out-of-core graph plane, held to the JAX package.

Held byte for byte: every ``.npy`` and ``meta.json`` a store directory
holds, built by ``store_from_graph``, ``build_sbm_store`` (arxiv and
reddit at scale 0.1, at two chunk sizes, one of which divides no edge
count) and ``build_rmat_store`` (scale 10); the chunked CSR builder
against ``from_edges``; the saved shard directories; and the store the
``launch/build_store`` CLI writes.  Each package opens the other's
store.  Held array-equal: ``ldg_partition``, ``stream_client_shards``
(retention None, 0 and 3, and a client subset), ``filter_shard_remote``,
``hash_partition`` and ``edge_cut``.

The port's trainer off a store is bit-equal to itself in memory (E and
OPG, two rounds: accuracies and losses ``==``, leaves ``torch.equal``),
and held to the JAX trainer off the same store from the JAX trainer's
initial leaves (``from_jax_leaves``): parameters within 1e-6 after the
first round (2e-7 measured) and within the training slice's 1e-4 after
the second (2.2e-6 measured with E), loss within a relative 1e-4: the
two frameworks' float32 sums add in different orders.  A store-backed
``RunConfig`` gives a fedsvc worker a shard-local trainer over its mmap'd
shard.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.federated import FederatedGNNTrainer as JTrainer
from repro.core.strategies import default_strategies as jstrategies
from repro.graphs import edge_cut as jedge_cut
from repro.graphs.partition import filter_shard_remote as jfilter
from repro.graphs import hash_partition as jhash_partition
from repro.graphs import make_client_shards as jmake_client_shards
from repro.graphs import make_graph as jmake_graph
from repro.graphs.graph import from_edges as jfrom_edges
from repro import graphstore as jgs
from repro_torch import graphstore as tgs
from repro_torch.core.federated import FederatedGNNTrainer as TTrainer
from repro_torch.core.strategies import default_strategies as tstrategies
from repro_torch.fedsvc.runtime import RunConfig
from repro_torch.graphs import (bfs_partition, edge_cut, filter_shard_remote,
                                hash_partition, make_client_shards,
                                make_graph)
from repro_torch.graphs.graph import from_edges
from repro_torch.models.gnn import from_jax_leaves

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHARD_FIELDS = ("indptr", "indices", "global_ids", "features", "labels",
                "train_mask", "pull_nodes", "push_nodes", "all_pull_nodes")
GRAPH_FIELDS = ("indptr", "indices", "features", "labels", "train_mask")


def tree_bytes(root) -> dict:
    """Every file under ``root`` (relative path → bytes)."""
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def assert_same_tree(a, b):
    ta, tb = tree_bytes(a), tree_bytes(b)
    assert sorted(ta) == sorted(tb)
    for name in ta:
        assert ta[name] == tb[name], name


def assert_shards_equal(xs, ys):
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):
        assert (x.client_id, x.num_local, x.num_classes) == \
            (y.client_id, y.num_local, y.num_classes)
        for f in SHARD_FIELDS:
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f),
                                          err_msg=f"client {x.client_id} {f}")


@pytest.fixture(scope="module")
def graph():
    return make_graph("arxiv", scale=0.15, seed=7)


@pytest.fixture(scope="module")
def stores(graph, tmp_path_factory):
    """The same graph written by each package's ``store_from_graph``."""
    d = tmp_path_factory.mktemp("stores")
    return (tgs.store_from_graph(graph, str(d / "port")),
            jgs.store_from_graph(jmake_graph("arxiv", scale=0.15, seed=7),
                                 str(d / "jax")))


# -- store files --------------------------------------------------------------

def test_store_from_graph_files_equal_jax(stores):
    port, jax_ = stores
    assert_same_tree(port.path, jax_.path)
    assert sorted(os.listdir(port.path)) == [
        "features.npy", "indices.npy", "indptr.npy", "labels.npy",
        "meta.json", "train_mask.npy"]


@pytest.mark.parametrize("preset,chunk", [("arxiv", 997), ("arxiv", 1 << 18),
                                          ("reddit", 997),
                                          ("reddit", 6000)])
def test_sbm_store_equal_make_graph_and_jax(tmp_path, preset, chunk):
    """The chunk replay of ``make_graph``'s stream: bit-equal to the
    in-memory graph and to the JAX store at a chunk size that divides no
    edge count (997) and at one that holds a whole graph or divides it
    (reddit at 0.1 has 24,000 pairs: 6,000 × 4)."""
    g = make_graph(preset, scale=0.1, seed=3)
    st = tgs.build_sbm_store(str(tmp_path / "port"), preset, scale=0.1,
                             seed=3, chunk_edges=chunk)
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(st, f), getattr(g, f), f)
    assert st.num_classes == g.num_classes
    jgs.build_sbm_store(str(tmp_path / "jax"), preset, scale=0.1, seed=3,
                        chunk_edges=chunk)
    assert_same_tree(tmp_path / "port", tmp_path / "jax")


def test_rmat_store_equal_jax(tmp_path):
    a = tgs.build_rmat_store(str(tmp_path / "port"), 10, edge_factor=8,
                             seed=5)
    jgs.build_rmat_store(str(tmp_path / "jax"), 10, edge_factor=8, seed=5)
    assert_same_tree(tmp_path / "port", tmp_path / "jax")
    a.validate()
    assert a.num_vertices == 1024 and a.train_mask.sum() >= a.num_classes
    b = tgs.open_store(str(tmp_path / "port"))
    np.testing.assert_array_equal(a.indices, b.indices)


@pytest.mark.parametrize("n_v,n_e,seed", [(10, 0, 0), (57, 300, 1),
                                          (400, 5000, 2)])
def test_builder_equal_from_edges_and_jax(tmp_path, n_v, n_e, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_v, n_e)
    dst = rng.integers(0, n_v, n_e)
    g = from_edges(n_v, src, dst, symmetric=True, dedup=True)
    st = tgs.build_csr_store(tgs.chunked(src, dst, 257), n_v,
                             str(tmp_path / "port"), est_pairs=max(1, n_e),
                             bucket_pairs=501)
    np.testing.assert_array_equal(st.indptr, g.indptr)
    np.testing.assert_array_equal(st.indices, g.indices)
    st.validate()
    jg = jfrom_edges(n_v, src, dst, symmetric=True, dedup=True)
    np.testing.assert_array_equal(jg.indices, g.indices)
    jgs.build_csr_store(jgs.chunked(src, dst, 257), n_v,
                        str(tmp_path / "jax"), est_pairs=max(1, n_e),
                        bucket_pairs=501)
    assert_same_tree(tmp_path / "port", tmp_path / "jax")
    with pytest.raises(ValueError, match="est_pairs"):
        tgs.build_csr_store(iter(()), n_v, str(tmp_path / "x"), est_pairs=0)


def test_each_package_opens_the_others_store(stores, graph):
    port, jax_ = stores
    for st in (tgs.open_store(jax_.path), jgs.open_store(port.path)):
        for f in GRAPH_FIELDS:
            np.testing.assert_array_equal(getattr(st, f), getattr(graph, f))
        assert st.is_store and st.num_classes == graph.num_classes
        assert (st.num_vertices, st.num_edges, st.feat_dim) == \
            (graph.num_vertices, graph.num_edges, graph.feat_dim)
        np.testing.assert_array_equal(st.train_vertices(),
                                      graph.train_vertices())
        np.testing.assert_array_equal(st.neighbours(5), graph.neighbours(5))
        np.testing.assert_array_equal(st.in_degree(), graph.in_degree())
        assert st.avg_degree() == graph.avg_degree()
        st.validate(chunk_vertices=100)
    # the store's arrays are read-only views of its files
    assert isinstance(port.indices, np.memmap)
    assert not port.features.flags.writeable


# -- partitions and shards ----------------------------------------------------

@pytest.mark.parametrize("k,chunk", [(2, 1 << 16), (4, 200), (7, 97)])
def test_ldg_partition_equal_jax(stores, graph, k, chunk):
    port, jax_ = stores
    a = tgs.ldg_partition(port, k, seed=1, chunk_vertices=chunk)
    np.testing.assert_array_equal(
        a, jgs.ldg_partition(jax_, k, seed=1, chunk_vertices=chunk))
    np.testing.assert_array_equal(
        a, tgs.ldg_partition(graph, k, seed=1, chunk_vertices=chunk))
    assert np.bincount(a, minlength=k).max() <= \
        int(np.ceil(graph.num_vertices / k) * 1.05)


def test_hash_partition_and_edge_cut_equal_jax(graph):
    jg = jmake_graph("arxiv", scale=0.15, seed=7)
    h = hash_partition(graph, 4, seed=3)
    np.testing.assert_array_equal(h, jhash_partition(jg, 4, seed=3))
    ldg = tgs.ldg_partition(graph, 4, seed=0)
    for part in (h, ldg, bfs_partition(graph, 4, seed=0)):
        assert edge_cut(graph, part) == jedge_cut(jg, part)


@pytest.mark.parametrize("limit,subset", [(None, None), (0, None), (3, None),
                                          (None, [1, 3]), (3, [2])])
def test_stream_client_shards_equal_jax(stores, graph, limit, subset):
    port, jax_ = stores
    part = tgs.ldg_partition(port, 4, seed=0)
    got = tgs.stream_client_shards(port, part, client_ids=subset,
                                   retention_limit=limit, seed=0,
                                   chunk_edges=251)
    want = jgs.stream_client_shards(jax_, part, client_ids=subset,
                                    retention_limit=limit, seed=0,
                                    chunk_edges=251)
    assert_shards_equal(got, want)
    full = make_client_shards(graph, part, retention_limit=limit, seed=0)
    ids = range(4) if subset is None else subset
    assert_shards_equal(got, [full[c] for c in ids])
    # the dispatch: streamed over a store, materialised for a Graph
    assert_shards_equal(tgs.build_client_shards(
        graph, part, client_ids=subset, retention_limit=limit, seed=0), got)


def test_saved_shards_equal_jax_and_load_read_only(stores, tmp_path):
    port, jax_ = stores
    k = 3
    part = tgs.ldg_partition(port, k, seed=0)
    for pkg, st in ((tgs, port), (jgs, jax_)):
        st.save_partition(part, k, 0)
        shards = pkg.stream_client_shards(st, part, retention_limit=4, seed=0)
        st.save_shards(shards, k, 0, 4)
    assert_same_tree(port.shards_dir(k, 0, 4), jax_.shards_dir(k, 0, 4))
    assert tree_bytes(port.path)[f"part_k{k}_s0.npy"] == \
        tree_bytes(jax_.path)[f"part_k{k}_s0.npy"]
    assert port.has_shards(k, 0, 4) and not port.has_shards(k, 0, None)
    np.testing.assert_array_equal(port.load_partition(k, 0), part)
    assert port.load_partition(k, 1) is None
    loaded = [port.load_shard(c, k, 0, 4) for c in range(k)]
    assert_shards_equal(loaded, jgs.stream_client_shards(
        jax_, part, retention_limit=4, seed=0))
    assert all(isinstance(sh.features, np.memmap)
               and not sh.features.flags.writeable for sh in loaded)
    assert not isinstance(port.load_shard(0, k, 0, 4, mmap=False).indices,
                          np.memmap)
    for a, b in zip(port.load_pull_nodes(k, 0, 4), loaded):
        np.testing.assert_array_equal(a, b.pull_nodes)


def test_filter_shard_remote_equal_jax_and_rebuild(graph):
    part = bfs_partition(graph, 3, seed=0)
    shards = make_client_shards(graph, part, retention_limit=None, seed=0)
    jshards = jmake_client_shards(jmake_graph("arxiv", scale=0.15, seed=7),
                                  part, retention_limit=None, seed=0)
    rng = np.random.default_rng(0)
    keep = {sh.client_id: np.sort(rng.choice(
        sh.pull_nodes, len(sh.pull_nodes) // 3, replace=False))
        for sh in shards}
    rebuilt = make_client_shards(graph, part, retained_remote=keep, seed=0)
    for sh, jsh in zip(shards, jshards):
        got = filter_shard_remote(sh, keep[sh.client_id])
        assert_shards_equal([got], [jfilter(jsh, keep[sh.client_id])])
        for f in ("indptr", "indices", "global_ids", "pull_nodes"):
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(rebuilt[sh.client_id], f))


# -- the trainer off a store --------------------------------------------------

def _fingerprint(tr, stats):
    return ([(s.accuracy, s.train_loss, s.embeddings_stored) for s in stats],
            tr.params_leaves())


@pytest.mark.parametrize("sname", ["E", "OPG"])
def test_trainer_off_store_bit_equal_in_memory(tmp_path, sname):
    g = make_graph("reddit", scale=0.08, seed=11)
    part = bfs_partition(g, 3, seed=0)
    kw = dict(batch_size=64, seed=0, part=part, epochs_per_round=2,
              hidden=16, device="cpu")
    st = tgs.store_from_graph(g, str(tmp_path / "g"))
    runs = []
    for graph_ in (g, st):
        tr = TTrainer(graph_, 3, tstrategies()[sname], **kw)
        runs.append(_fingerprint(tr, tr.train(2)))
    (ma, ml), (sa, sl) = runs
    assert ma == sa
    assert all(torch.equal(torch.from_numpy(a), torch.from_numpy(b))
               for a, b in zip(ml, sl))


def test_trainer_off_store_partitions_by_ldg(tmp_path, graph):
    st = tgs.store_from_graph(graph, str(tmp_path / "g"))
    tr = TTrainer(st, 3, tstrategies()["D"], batch_size=32, seed=2,
                  device="cpu")
    np.testing.assert_array_equal(tr.part, tgs.ldg_partition(st, 3, seed=2))
    assert 0.0 <= tr.evaluate() <= 1.0


def test_port_trainer_matches_jax_off_one_store(tmp_path):
    """One store, built by the JAX package; both trainers partition it
    by LDG and stream its shards; the port starts from the JAX leaves."""
    jst = jgs.build_sbm_store(str(tmp_path / "g"), "arxiv", scale=0.1,
                              seed=7)
    kw = dict(num_layers=3, hidden=16, batch_size=64, epochs_per_round=2,
              seed=0)
    jt = JTrainer(jst, 2, jstrategies()["OPG"], **kw)
    tt = TTrainer(tgs.open_store(jst.path), 2, tstrategies()["OPG"],
                  model=from_jax_leaves(jt.params_leaves(), "graphconv",
                                        device="cpu"), device="cpu", **kw)
    np.testing.assert_array_equal(tt.part, jt.part)
    assert_shards_equal(tt.shards, jt.shards)
    jt.pretrain_round()
    tt.pretrain_round()
    for r, atol in enumerate((1e-6, 1e-4)):
        js, ts = jt.run_round(r, 0.0), tt.run_round(r, 0.0)
        assert ts.pull_rpc_sizes == js.pull_rpc_sizes
        assert ts.embeddings_stored == js.embeddings_stored
        assert ts.train_loss == pytest.approx(js.train_loss, rel=1e-4)
        for a, b in zip(tt.params_leaves(), jt.params_leaves()):
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)
        assert abs(ts.accuracy - js.accuracy) <= 1.0 / len(jt.test_idx)


def _bake(tmp_path, graph, k, seed, limit=None):
    """A store with its LDG partition and its reciprocal push sets baked,
    as the JAX package's test of the shard-local worker bakes them."""
    st = tgs.store_from_graph(graph, str(tmp_path / "g"))
    part = tgs.ldg_partition(st, k, seed=seed)
    st.save_partition(part, k, seed)
    shards = tgs.stream_client_shards(st, part, retention_limit=limit,
                                      seed=seed)
    for sh in shards:
        wanted = [o.pull_nodes[part[o.pull_nodes] == sh.client_id]
                  for o in shards if o.client_id != sh.client_id]
        sh.push_nodes = np.unique(np.concatenate(wanted))
    st.save_shards(shards, k, seed, limit)
    return st, part, shards


def test_store_runconfig_shard_local_worker(tmp_path, graph):
    k, seed = 3, 0
    st, part, shards = _bake(tmp_path, graph, k, seed)
    cfg = RunConfig(graph=f"store:{st.path}", num_clients=k, strategy="E",
                    rounds=1, seed=seed, hidden=16)
    tr = cfg.build_trainer(only_clients=[1], device="cpu")
    assert tr.samplers[1] is not None and tr.samplers[0] is None
    assert tr.shards[0] is None and tr.ex_clients[0] is None
    assert tr.eval_arrays is None
    with pytest.raises(RuntimeError, match="no eval"):
        tr.evaluate()
    assert isinstance(tr.shards[1].features, np.memmap)
    tr.pretrain_round()
    res = tr.client_round(1)
    assert res.client_id == 1 and np.isfinite(res.loss)
    assert_shards_equal([tr.shards[1]], [shards[1]])
    # every client's prebuilt shard files: bit-equal to the in-memory
    # trainer over the same partition
    s_store = cfg.build_trainer(device="cpu")
    assert all(isinstance(sh.indices, np.memmap) for sh in s_store.shards)
    a = _fingerprint(s_store, s_store.train(1))
    tr_mem = TTrainer(graph, k, cfg.build_strategy(), hidden=16,
                      batch_size=cfg.batch_size, seed=seed, part=part,
                      device="cpu")
    b = _fingerprint(tr_mem, tr_mem.train(1))
    assert a[0] == b[0]
    assert all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))


def test_prebuilt_shards_under_scored_pruning(tmp_path, graph):
    """OPG over prebuilt P_4 shards filters each owned shard on its own
    (``filter_shard_remote``): the same pull sets, shards and first round
    as the trainer that rebuilds the shards from the graph."""
    k, seed = 2, 0
    st, part, _ = _bake(tmp_path, graph, k, seed, limit=4)
    cfg = RunConfig(graph=f"store:{st.path}", num_clients=k,
                    strategy="OPG", overrides={"score_kind": "degree"},
                    rounds=1, seed=seed, hidden=16, epochs_per_round=1)
    pre = cfg.build_trainer(device="cpu")
    assert pre._prebuilt_shards is not None
    mem = TTrainer(graph, k, cfg.build_strategy(), hidden=16,
                   epochs_per_round=1, seed=seed, part=part, device="cpu")
    assert_shards_equal(pre.shards, mem.shards)
    a, b = pre.train(1), mem.train(1)
    assert [s.accuracy for s in a] == [s.accuracy for s in b]
    assert [s.train_loss for s in a] == [s.train_loss for s in b]


# -- the CLI ------------------------------------------------------------------

def _cli(module, out, *extra, check_torch=False):
    code = (f"import sys, json; from {module} import main; "
            f"main(sys.argv[1:]); ")
    if check_torch:
        code += "assert 'torch' not in sys.modules, 'the build imported torch'"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-c", code, "--out", str(out), "--preset", "arxiv",
         "--scale", "0.1", "--graph-seed", "3", "--seed", "0",
         "--clients", "2", *extra],
        capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_build_store_cli_equal_jax(tmp_path):
    port = _cli("repro_torch.launch.build_store", tmp_path / "port",
                "--retention", "3", check_torch=True)
    jax_ = _cli("repro.launch.build_store", tmp_path / "jax",
                "--retention", "3")
    assert_same_tree(tmp_path / "port", tmp_path / "jax")
    assert sorted(port) == sorted(jax_)
    for key in ("num_vertices", "num_edges", "clients", "part_sizes",
                "boundary_pull_nodes"):
        assert port[key] == jax_[key], key
    assert port["peak_rss_mb"] > 0
    st = tgs.open_store(str(tmp_path / "port"))
    assert st.has_shards(2, 0, 3)
    np.testing.assert_array_equal(st.load_partition(2, 0),
                                  tgs.ldg_partition(st, 2, seed=0))
