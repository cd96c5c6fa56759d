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


# -- the compiled neighbour draw --------------------------------------------


#: local vertices of a drawn CSR; ids from here up are remote
_N_LOCAL = 20_000


def _csr(degrees, remote, seed=0):
    """In-edges of the first ``len(degrees)`` of ``_N_LOCAL`` local
    vertices, to random ids, half of them remote where ``remote``."""
    deg = np.zeros(_N_LOCAL, np.int64)
    deg[: len(degrees)] = degrees
    indptr = np.concatenate([[0], np.cumsum(deg)])
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 2 * _N_LOCAL if remote else _N_LOCAL, indptr[-1])
    return indptr, ids.astype(np.int32)


# (degrees, fanout, local_only, frontier (ids from _N_LOCAL up remote),
# remote neighbours, a half-used 64-bit word on entry, vertices handed
# to rng.choice)
_R = _N_LOCAL
_DRAW_CASES = {
    "degree_eq_fanout": ([5, 5, 5], 5, False, [0, 1, 2], False, False, 0),
    "degree_one_above": ([6, 6, 6, 6], 5, False, [3, 0, 2, 1], False, False,
                         0),
    "degree_far_above": ([900, 2000, 9999], 5, False, [0, 1, 2, 1], False,
                         False, 0),
    "local_only": ([40, 8, 120], 5, True, [0, 1, 2, 0], True, False, 0),
    "remote_frontier": ([30, 30], 5, False, [_R, 0, _R + 7, 1, _R], True,
                        False, 0),
    "empty_lists": ([0, 12, 0, 3], 5, True, [0, 1, 2, 3], True, False, 0),
    "half_word_on_entry": ([50, 7, 300], 5, False, [0, 1, 2, 2], False, True,
                           0),
    "tail_shuffle": ([40, 12000, 30], 250, False, [0, 1, 2], False, False, 1),
    "tail_shuffle_edge": ([12000, 12050], 240, False, [0, 1], False, False,
                          0),
}


@pytest.mark.parametrize("case", list(_DRAW_CASES))
def test_compiled_draw_matches_choice(case):
    """The compiled pass gives the ``rng.choice`` loop's edges and leaves
    the generator in its state, half-used word included; numpy's
    tail-shuffle branch (population over 10000, fanout over a fiftieth of
    it) goes through the fallback, and only it."""
    from repro_torch.graphs import sampler as S

    degrees, fanout, local_only, frontier, remote, half, fallback = \
        _DRAW_CASES[case]
    indptr, indices = _csr(degrees, remote, seed=len(case))
    frontier = np.array(frontier, np.int64)
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    if half:
        a.random(dtype=np.float32), b.random(dtype=np.float32)
        assert a.bit_generator.state["has_uint32"] == 1
    before = dict(S.DRAWS)
    got = S.draw_neighbors(frontier, indptr, indices, _N_LOCAL, fanout,
                           local_only, a)
    want = S._choice_loop(frontier, indptr, indices, _N_LOCAL, fanout,
                          local_only, b)
    for g, w, what in zip(got, want, ("edge_src", "edge_dst")):
        _same(g, w, what)
    assert a.bit_generator.state == b.bit_generator.state
    assert S.DRAWS["fallback"] - before["fallback"] == fallback
    # the next draws from either generator agree as well
    assert a.integers(0, 1 << 40, 4).tolist() == \
        b.integers(0, 1 << 40, 4).tolist()


@pytest.mark.parametrize("fault", ["indptr_int32", "indices_int64",
                                   "indices_strided", "indptr_short",
                                   "indices_short"])
def test_draw_rejects_a_malformed_csr(fault):
    """The pass reads raw pointers, so the arrays it is handed are checked
    first."""
    from repro_torch.graphs import sampler as S

    indptr, indices = _csr([30, 40], False)
    num_local = _N_LOCAL
    if fault == "indptr_int32":
        indptr = indptr.astype(np.int32)
    elif fault == "indices_int64":
        indices = indices.astype(np.int64)
    elif fault == "indices_strided":
        indices = np.repeat(indices, 2)[::2]
    elif fault == "indptr_short":
        num_local = len(indptr)
    else:
        indices = indices[:-1]
    with pytest.raises(ValueError, match="contiguous"):
        S.draw_neighbors(np.arange(2), indptr, indices, num_local, 5, False,
                         np.random.default_rng(0))


def test_sampler_hops_keep_numpy_state():
    """Hop by hop over two epochs of reddit shards, the sampler's draw
    gives the ``rng.choice`` loop's edges and generator state."""
    from repro_torch.graphs.sampler import _choice_loop

    g = tgraphs.make_graph("reddit", scale=0.2, seed=5)
    part = tgraphs.bfs_partition(g, 2, seed=5)
    for sh in tgraphs.make_client_shards(g, part, retention_limit=4, seed=5):
        ts = tgraphs.NeighborSampler(sh, 5, 3, 64, seed=5)
        twin = np.random.default_rng()
        for _ in range(2):
            order = ts._train.copy()
            ts.rng.shuffle(order)
            twin.bit_generator.state = ts.rng.bit_generator.state
            for i in range(0, len(order), 64):
                cur = order[i: i + 64].astype(np.int64)
                for hop in (1, 2, 3):
                    got = ts._sample_neighbors(cur, local_only=hop == 3)
                    want = _choice_loop(cur, sh.indptr, sh.indices,
                                        sh.num_local, 5, hop == 3, twin)
                    for a, b, what in zip(got, want, ("src", "dst")):
                        _same(a, b, f"hop {hop} {what}")
                    assert ts.rng.bit_generator.state == \
                        twin.bit_generator.state, f"hop {hop}"
                    cur = np.concatenate(
                        [cur, np.setdiff1d(np.unique(got[0]), cur)])


def test_draw_counters():
    """A reddit epoch draws every vertex in the compiled pass (its count
    is the local frontier vertices with more candidates than the fanout)
    and hands none back; numpy's tail-shuffle branch hands one back."""
    from repro_torch.graphs import sampler as S

    g = tgraphs.make_graph("reddit", scale=0.2, seed=2)
    part = tgraphs.bfs_partition(g, 2, seed=2)
    sh = tgraphs.make_client_shards(g, part, retention_limit=4, seed=2)[0]
    ts = tgraphs.NeighborSampler(sh, 5, 3, 64, seed=2)
    before = dict(S.DRAWS)
    want = 0
    for mb in ts.epoch():
        for hop in (1, 2, 3):
            blk = mb.blocks[3 - hop]        # its dst nodes: hop's frontier
            for u in blk.src_ids[: blk.n_dst]:
                if u >= sh.num_local:
                    continue
                nbrs = sh.indices[sh.indptr[u]: sh.indptr[u + 1]]
                if hop == 3:
                    nbrs = nbrs[nbrs < sh.num_local]
                want += len(nbrs) > 5
    assert want > 1000
    assert S.DRAWS["compiled"] - before["compiled"] == want
    assert S.DRAWS["fallback"] == before["fallback"]

    indptr, indices = _csr([12000], False)
    S.draw_neighbors(np.zeros(1, np.int64), indptr, indices, _N_LOCAL, 250,
                     False, np.random.default_rng(0))
    assert S.DRAWS["fallback"] == before["fallback"] + 1


def test_draw_check_raises_on_a_wrong_draw(monkeypatch):
    """The first-use probe refuses a pass whose picks differ from
    ``rng.choice``'s."""
    import ctypes

    from repro_torch.graphs import sampler as S

    real = S._run_pass

    def off_by_one(args):
        n = real(args)
        if n:
            ctypes.cast(args.out_src, ctypes.POINTER(ctypes.c_int64))[0] += 1
        return n

    monkeypatch.setattr(S, "_checked", set())
    monkeypatch.setattr(S, "_run_pass", off_by_one)
    with pytest.raises(RuntimeError, match="no longer replays"):
        S.check_draw(5)
    assert 5 not in S._checked
    monkeypatch.setattr(S, "_run_pass", real)
    S.check_draw(5)
    assert 5 in S._checked


def test_host_library_builds_and_is_reused(tmp_path, monkeypatch):
    """The host library builds on the CPU into the build directory, is
    loaded from there again without a compile, and an edited source is
    named anew."""
    import shutil

    from repro_torch.kernels import _host

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    shutil.copy(_host.CSRC / "neighbor_draw.cpp", csrc)
    monkeypatch.setattr(_host, "CSRC", csrc)
    monkeypatch.setattr(_host, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_host, "_libs", {})
    lib = _host.library("neighbor_draw")
    path = _host.lib_path("neighbor_draw")
    assert path.parent == tmp_path / "build" and path.exists()
    assert lib.neighbor_draw
    stamp = path.stat().st_mtime_ns

    def no_compile(*_):
        raise AssertionError("an unchanged source was compiled again")

    monkeypatch.setattr(_host, "_libs", {})
    monkeypatch.setattr(_host, "_compile", no_compile)
    _host.library("neighbor_draw")
    assert path.stat().st_mtime_ns == stamp
    assert list((tmp_path / "build").iterdir()) == [path]

    with open(csrc / "neighbor_draw.cpp", "a") as f:
        f.write("// edited\n")
    assert _host.lib_path("neighbor_draw") != path
