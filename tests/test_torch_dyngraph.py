"""The port's dynamic-graph plane, held to the JAX package.

Held byte for byte or array-equal: a growth schedule's geometry, event
batches, node rows (across a node-block boundary) and its base and full
stores; after every event, each accessor of the merged overlay (indptr,
slices and fancy indexing of the merged indices, ``__array__``, the
stacked node arrays, ``in_degree``, ``neighbours``, ``gather_rows``)
and each segment; the delta log's files, which each package loads from
the other; the compacted store, against JAX's compaction and
``build_full``; ``admit``, ``restream_pass``, ``repartition`` and
``edge_cut_stream`` under LDG and Fennel; the growth runtime's
``pt_dyngraph.*`` metrics against JAX's ``dyngraph.*``; and the growth
frame, which a port worker sends to a JAX coordinator and a JAX worker
to a port one.

The port's trainer with an empty schedule is bit-equal to the static
trainer.  A grown run of strategy D, one of OPG with int8, error
feedback and a linear τ schedule, and one of E over 4 shards placed by
pull frequency (rows grown past the placement map hash, as in JAX),
from the JAX trainer's initial leaves (``from_jax_leaves``), keeps the
partition, shards, registered rows, shard placement and logs, eval
sample and τ sequence exact and its parameters within 1e-6 after
the first round and 1e-4 after the later ones (1e-3 with int8): the
two frameworks' float32 sums add in different orders.  The boundary
registration counter equals the set difference counted here.  Growth
requires sync aggregation.  A deployment of two port workers in
threads grows bit-equal to the in-process grown trainer, and the mixed
deployments (a JAX coordinator with port workers, and the reverse) give
their references' leaves bit for bit.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from repro import dyngraph as jdyn
from repro.dyngraph import wire as jwire
from repro.fedsvc.coordinator import CoordinatorState as JCoordState
from repro.fedsvc.coordinator import serve_in_thread as jcoord_serve
from repro.fedsvc.protocol import CoordinatorClient as JCoordClient
from repro.fedsvc.runtime import EvalHarness as JHarness
from repro.fedsvc.runtime import RunConfig as JRunConfig
from repro.fedsvc.worker import FedWorker as JWorker
from repro.fedsvc.worker import run_in_thread as jrun_in_thread
from repro.graphstore import ldg_partition as jldg
from repro.obsv.metrics import REGISTRY as JREGISTRY
from repro_torch import dyngraph as tdyn
from repro_torch.dyngraph import wire as twire
from repro_torch.fedsvc.coordinator import CoordinatorState, serve_in_thread
from repro_torch.fedsvc.runtime import (EvalHarness, RunConfig,
                                        make_coordinator_state)
from repro_torch.fedsvc.worker import FedWorker, run_in_thread
from repro_torch.graphstore import ldg_partition, open_store
from repro_torch.launch.embed_server import serve_in_thread as embed_serve
from repro_torch.models.gnn import from_jax_leaves
from repro_torch.obsv.metrics import REGISTRY

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")
torch.set_num_threads(1)

SCHED = dict(scale=9, seed=7, base_frac=0.5, num_events=4, num_classes=8,
             feat_dim=16)
T_SCHED = dict(scale=10, seed=7, base_frac=0.5, num_events=2,
               start_round=1, every_rounds=1, num_classes=8, feat_dim=16)
T_KW = dict(num_clients=2, batch_size=64, epochs_per_round=2, seed=0,
            strategy="D", rounds=4)
ARRAYS = ("indptr", "indices", "features", "labels", "train_mask")
NODES = ("features", "labels", "train_mask")
STORE_FILES = ARRAYS + ("meta",)


def _file_bytes(path, key):
    name = "meta.json" if key == "meta" else f"{key}.npy"
    with open(os.path.join(path, name), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def grown(tmp_path_factory):
    """Each package's base store, its overlays after every event (one
    snapshot per epoch) and its full build."""
    root = tmp_path_factory.mktemp("dyn")
    out = {}
    for tag, pkg in (("jax", jdyn), ("port", tdyn)):
        sched = pkg.GrowthSchedule(**SCHED)
        base = sched.build_base(str(root / tag / "base"))
        views = [pkg.GraphOverlay(base)]
        for e in range(1, sched.num_events + 1):
            ov = pkg.GraphOverlay(base, views[-1].segments)
            ov.apply(*sched.event_batch(e))
            views.append(ov)
        full = sched.build_full(str(root / tag / "full"))
        out[tag] = dict(sched=sched, base=base, views=views, full=full,
                        root=root / tag)
    return out


# -- schedules -----------------------------------------------------------------

def test_schedule_matches_jax():
    t, j = tdyn.GrowthSchedule(**SCHED), jdyn.GrowthSchedule(**SCHED)
    assert t.to_dict() == j.to_dict()
    assert tdyn.GrowthSchedule.from_dict(j.to_dict()) == t
    assert (t.num_vertices, t.base_vertices) == (j.num_vertices,
                                                 j.base_vertices)
    for e in range(-1, t.num_events + 2):
        assert t.frontier(e) == j.frontier(e)
    for r in range(8):
        assert t.epoch_for_round(r) == j.epoch_for_round(r)
    for e in range(1, t.num_events + 1):
        ts, td, tn = t.event_batch(e)
        js, jd, jn = j.event_batch(e)
        assert ts.tobytes() == js.tobytes() and td.tobytes() == jd.tobytes()
        assert ts.dtype == js.dtype == np.int64
        for k in NODES:
            assert tn[k].dtype == jn[k].dtype
            assert tn[k].tobytes() == jn[k].tobytes()
    for a, b in zip(t.full_chunks(), j.full_chunks()):
        assert a[0].tobytes() == b[0].tobytes()
        assert a[1].tobytes() == b[1].tobytes()


def test_node_rows_match_jax_across_blocks():
    """Rows of a band that crosses a 4096-row block, from the start and
    past the class-seeding prefix: the same bytes as JAX's."""
    kw = dict(scale=13, seed=3, num_classes=41, feat_dim=12)
    t, j = tdyn.GrowthSchedule(**kw), jdyn.GrowthSchedule(**kw)
    for lo, hi in ((0, 64), (4000, 4200), (8100, 8192)):
        a, b = t.node_rows(lo, hi), j.node_rows(lo, hi)
        for k in NODES:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes()


@pytest.mark.parametrize("which", ["base", "full"])
def test_schedule_stores_byte_equal(grown, which):
    tp = grown["port"]["root"] / which
    jp = grown["jax"]["root"] / which
    for key in STORE_FILES:
        assert _file_bytes(tp, key) == _file_bytes(jp, key), key


# -- overlays ------------------------------------------------------------------

def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("epoch", range(5))
def test_overlay_accessors_match_jax(grown, epoch):
    t = grown["port"]["views"][epoch]
    j = grown["jax"]["views"][epoch]
    assert (t.num_vertices, t.num_edges) == (j.num_vertices, j.num_edges)
    assert (t.feat_dim, t.num_classes) == (j.feat_dim, j.num_classes)
    assert len(t.segments) == len(j.segments) == epoch
    for st, sj in zip(t.segments, j.segments):
        assert (st.v_lo, st.v_hi, st.num_edges) == (sj.v_lo, sj.v_hi,
                                                   sj.num_edges)
        _same(st.indptr, sj.indptr)
        _same(st.indices, sj.indices)
        for k in NODES:
            _same(st.nodes[k], sj.nodes[k])
    _same(t.indptr, j.indptr)
    rng = np.random.default_rng(epoch)
    pos = rng.integers(0, t.num_edges, 300)
    rows = rng.integers(0, t.num_vertices, 50)
    e, v = t.num_edges, t.num_vertices
    for key in ARRAYS[1:]:
        a, b = getattr(t, key), getattr(j, key)
        _same(a, b)                                   # __array__
        n = e if key == "indices" else v
        idx = pos if key == "indices" else rows
        _same(a[idx], b[idx])                         # fancy
        for sl in (slice(0, n), slice(n // 3, n // 2), slice(n - 1, n)):
            _same(a[sl], b[sl])
        assert len(a) == len(b) == n
    _same(t.in_degree(), j.in_degree())
    _same(t.in_degree(rows), j.in_degree(rows))
    for u in rows[:10]:
        _same(t.neighbours(int(u)), j.neighbours(int(u)))
    for x, y in zip(t.gather_rows(rows), j.gather_rows(rows)):
        _same(x, y)
    _same(t.train_vertices(), j.train_vertices())


def test_empty_overlay_is_passthrough(grown):
    base = grown["port"]["base"]
    ov = tdyn.GraphOverlay(base)
    assert ov.indices is base.indices and ov.features is base.features
    assert ov.labels is base.labels and ov.train_mask is base.train_mask
    np.testing.assert_array_equal(ov.indptr, np.asarray(base.indptr))
    with pytest.raises(ValueError, match="beyond"):
        ov.apply(np.array([0]), np.array([base.num_vertices]))


def test_overlay_matches_full_build(grown):
    ov, full = grown["port"]["views"][-1], grown["port"]["full"]
    assert (ov.num_vertices, ov.num_edges) == (full.num_vertices,
                                               full.num_edges)
    for key in ARRAYS:     # the merged indices are int64, the store's int32
        np.testing.assert_array_equal(np.asarray(getattr(ov, key)),
                                      np.asarray(getattr(full, key)))


def test_delta_logs_byte_equal_and_cross_load(grown, tmp_path):
    tv, jv = grown["port"]["views"][-1], grown["jax"]["views"][-1]
    tlog, jlog = tdyn.DeltaLog(str(tmp_path / "t")), \
        jdyn.DeltaLog(str(tmp_path / "j"))
    for s in tv.segments:
        tlog.append(s)
    for s in jv.segments:
        jlog.append(s)
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes(), n
    for ov in (tdyn.DeltaLog(str(tmp_path / "j")).load(grown["port"]["base"]),
               jdyn.DeltaLog(str(tmp_path / "t")).load(grown["jax"]["base"])):
        assert len(ov.segments) == len(tv.segments)
        for key in ARRAYS:
            _same(getattr(ov, key), getattr(tv, key))


def test_compaction_byte_equal_to_jax_and_full(grown, tmp_path):
    tv, jv = grown["port"]["views"][-1], grown["jax"]["views"][-1]
    before = REGISTRY.snapshot("pt_dyngraph.compact_s") \
        .get("pt_dyngraph.compact_s", {}).get("count", 0)
    tdyn.compact(tv, str(tmp_path / "t"), name="dyn_full")
    jdyn.compact(jv, str(tmp_path / "j"), name="dyn_full")
    full = grown["port"]["root"] / "full"
    for key in ARRAYS:
        b = _file_bytes(tmp_path / "t", key)
        assert b == _file_bytes(tmp_path / "j", key), key
        assert b == _file_bytes(full, key), key
    assert json.loads(_file_bytes(tmp_path / "t", "meta")) == \
        json.loads(_file_bytes(tmp_path / "j", "meta"))
    open_store(str(tmp_path / "t")).validate()
    snap = REGISTRY.snapshot("pt_dyngraph.compact_s")
    assert snap["pt_dyngraph.compact_s"]["count"] == before + 1


# -- restreaming ---------------------------------------------------------------

@pytest.mark.parametrize("method", ["ldg", "fennel"])
def test_restreaming_matches_jax(grown, method):
    tv, jv = grown["port"]["views"][-1], grown["jax"]["views"][-1]
    k = 4
    p0 = ldg_partition(grown["port"]["base"], k, seed=0)
    np.testing.assert_array_equal(p0, jldg(grown["jax"]["base"], k, seed=0))
    tc = tdyn.RestreamConfig(method=method, passes=2, seed=3,
                             chunk_vertices=100)
    jc = jdyn.RestreamConfig(method=method, passes=2, seed=3,
                             chunk_vertices=100)
    ta, ja = tdyn.admit(tv, p0, k, tc), jdyn.admit(jv, p0, k, jc)
    _same(ta, ja)
    np.testing.assert_array_equal(ta[:len(p0)], p0)
    _same(tdyn.restream_pass(tv, ta, k, tc), jdyn.restream_pass(jv, ja, k,
                                                                jc))
    tr, jr = tdyn.repartition(tv, p0, k, tc), jdyn.repartition(jv, p0, k, jc)
    _same(tr, jr)
    for part in (ta, tr):
        for ce in (1 << 21, 97):
            assert tdyn.edge_cut_stream(tv, part, ce) == \
                jdyn.edge_cut_stream(jv, part, ce)
    if method == "ldg":
        assert tdyn.edge_cut_stream(tv, tr) <= tdyn.edge_cut_stream(tv, ta)


def test_growth_runtime_metrics_match_jax(grown):
    names = ("segments", "edge_cut", "boundary_registrations")
    tb = REGISTRY.snapshot("pt_dyngraph.").get(
        "pt_dyngraph.boundary_registrations", 0)
    jb = JREGISTRY.snapshot("dyngraph.").get(
        "dyngraph.boundary_registrations", 0)
    trt = tdyn.GrowthRuntime(tdyn.GrowthSchedule(**SCHED),
                             grown["port"]["base"], 4, passes=1)
    jrt = jdyn.GrowthRuntime(jdyn.GrowthSchedule(**SCHED),
                             grown["jax"]["base"], 4, passes=1)
    p0 = ldg_partition(grown["port"]["base"], 4, seed=0)
    for epoch, part in ((2, p0), (2, None), (1, None), (4, None)):
        assert trt.advance_to(epoch, part=part) == \
            jrt.advance_to(epoch, part=part)
        assert trt.applied_epoch == jrt.applied_epoch
        _same(trt.part, jrt.part)
        assert trt.graph.num_vertices == jrt.graph.num_vertices
        assert trt.epoch_for_round(epoch) == jrt.epoch_for_round(epoch)
    trt.record_boundary(17)
    jrt.record_boundary(17)
    t = REGISTRY.snapshot("pt_dyngraph.")
    j = JREGISTRY.snapshot("dyngraph.")
    for n in names[:2]:
        assert t[f"pt_dyngraph.{n}"] == j[f"dyngraph.{n}"] > 0, n
    assert t["pt_dyngraph.boundary_registrations"] - tb == \
        j["dyngraph.boundary_registrations"] - jb == 17


# -- the growth frame ----------------------------------------------------------

HEADER = {"worker_id": "w0", "round": 3, "epoch": 2, "num_vertices": 512,
          "num_edges": 4096}


def test_growth_frames_byte_equal():
    assert twire.PT_OP_GROWTH == jwire.OP_GROWTH
    assert (twire.GROWTH_LO, twire.GROWTH_HI) == (jwire.GROWTH_LO,
                                                  jwire.GROWTH_HI)
    body = twire.build_growth(HEADER)
    assert body == jwire.build_growth(HEADER)
    for parse in (twire.parse_growth_request, jwire.parse_growth_request):
        assert parse(body) == (48, HEADER)
    with pytest.raises(ValueError, match="unknown growth opcode"):
        twire.parse_growth_request(bytes([twire.GROWTH_HI]) + b"\x00" * 8)


@pytest.mark.parametrize("coord", ["jax", "port"])
def test_growth_rpc_crosses_packages(coord):
    """The other package's growth frames against a coordinator: the
    barrier withholds the first worker's reply until the second worker
    reports the epoch too, and a bad frame answers an error."""
    growth = jdyn.GrowthSchedule(**T_SCHED)
    if coord == "jax":
        state = JCoordState(num_clients=2, num_rounds=1, growth=growth)
        serve, wire_mod = jcoord_serve, twire
    else:
        state = CoordinatorState(num_clients=2, num_rounds=1, device="cpu",
                                 growth=growth)
        serve, wire_mod = serve_in_thread, jwire
    with serve(state) as h:
        a, b = JCoordClient(h.address), JCoordClient(h.address)
        a.hello("w0", [0], init_leaves=[np.zeros(3, np.float32)])
        b.hello("w1", [1])
        head, _ = a.get_model(0)
        assert head["growth_epoch"] == growth.epoch_for_round(0) == 0
        wire_mod.send_frame(a.sock, wire_mod.build_growth(
            dict(HEADER, worker_id="w0", epoch=1)))
        # w0 waits on w1: its report is in, its reply is not
        deadline = time.monotonic() + 10
        while state.grown != {"w0": 1} and time.monotonic() < deadline:
            time.sleep(0.01)
        assert state.grown == {"w0": 1}
        wire_mod.growth_rpc(b.sock, dict(HEADER, worker_id="w1", epoch=1))
        assert state.grown == {"w0": 1, "w1": 1}
        wire_mod.parse_response(wire_mod.recv_frame(a.sock))
        wire_mod.send_frame(a.sock, bytes([63]))
        with pytest.raises(RuntimeError, match="unknown growth opcode"):
            wire_mod.parse_response(wire_mod.recv_frame(a.sock))
        a.close()
        b.close()


# -- the trainer ---------------------------------------------------------------

@pytest.fixture(scope="module")
def t_base(tmp_path_factory):
    root = tmp_path_factory.mktemp("dyn_trainer")
    tdyn.GrowthSchedule(**T_SCHED).build_base(str(root / "base"))
    return str(root / "base")


def _accs(stats):
    return [r.accuracy for r in stats]


def test_empty_schedule_is_bit_identical_to_static(tmp_path):
    sched = tdyn.GrowthSchedule(**dict(SCHED, num_events=0, base_frac=1.0))
    sched.build_base(str(tmp_path / "g"))
    kw = dict(T_KW, graph="store:" + str(tmp_path / "g"), rounds=3)
    static = RunConfig(**kw).build_trainer(device="cpu")
    h0 = static.train(3)
    dyn = RunConfig(growth=sched.to_dict(), **kw).build_trainer(device="cpu")
    h1 = dyn.train(3)
    assert _accs(h0) == _accs(h1)
    assert [s.train_loss for s in h0] == [s.train_loss for s in h1]
    for a, b in zip(static.params_leaves(), dyn.params_leaves()):
        assert torch.equal(torch.from_numpy(a), torch.from_numpy(b))
    assert dyn.growth.applied_epoch == 0 and dyn.g is dyn.growth.base


TAU = dict(codec="int8", error_feedback=True, delta_threshold=0.05,
           delta_schedule="linear", delta_rounds=3)
PULL_FREQ = dict(shard_placement="pull_frequency", num_server_shards=4,
                 rebalance_round=1)
GROWN = {"D": ("D", {}), "OPG-int8-ef-tau": ("OPG", TAU),
         "E-pull-frequency-4-shards": ("E", PULL_FREQ)}


def _registered_union(tr):
    sets = [np.zeros(0, np.int64)]
    for ci in tr.owned:
        sets += [tr.shards[ci].pull_nodes, tr.shards[ci].push_nodes]
    return np.unique(np.concatenate(sets))


@pytest.mark.parametrize("case", list(GROWN))
def test_grown_run_matches_jax(t_base, case):
    strat, over = GROWN[case]
    kw = dict(T_KW, strategy=strat, overrides=over,
              graph="store:" + t_base)
    jt = JRunConfig(growth=T_SCHED, **kw).build_trainer()
    tt = RunConfig(growth=T_SCHED, **kw).build_trainer(device="cpu")
    tt.model = from_jax_leaves(jt.params_leaves(), "graphconv", device="cpu")
    lossy = "int8" in case
    jt.pretrain_round()
    tt.pretrain_round()
    counter = "pt_dyngraph.boundary_registrations"
    seen = _registered_union(tt)
    jcum = tcum = 0.0
    for r in range(T_KW["rounds"]):
        before = REGISTRY.snapshot("pt_dyngraph.").get(counter, 0)
        jg = jt.apply_growth(jt.growth.epoch_for_round(r), r)
        assert tt.apply_growth(tt.growth.epoch_for_round(r), r) == jg
        now = _registered_union(tt)
        fresh = len(np.setdiff1d(now, seen)) if tt.exchange else 0
        assert REGISTRY.snapshot("pt_dyngraph.").get(counter, 0) - before \
            == fresh
        seen = np.union1d(seen, now)      # registration is append-only
        assert tt.growth.applied_epoch == jt.growth.applied_epoch
        assert tt.g.num_vertices == jt.g.num_vertices == \
            tdyn.GrowthSchedule(**T_SCHED).frontier(tt.growth.applied_epoch)
        assert len(tt.part) == len(jt.part) == tt.g.num_vertices
        np.testing.assert_array_equal(tt.part, jt.part)
        np.testing.assert_array_equal(tt.eval_gids, jt.eval_gids)
        for ci in range(2):
            a, b = tt.shards[ci], jt.shards[ci]
            for f in ("indptr", "indices", "global_ids", "pull_nodes",
                      "push_nodes", "all_pull_nodes"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            np.testing.assert_array_equal(tt.push_rows[ci], jt.push_rows[ci])
        if tt.exchange is not None:
            np.testing.assert_array_equal(tt._registered, jt._registered)
            np.testing.assert_array_equal(tt._registered, seen)
            assert tt.exchange.num_embeddings_stored == \
                len(seen) * (tt.L - 1)
            # rows grown past a pull-frequency placement map hash, as
            # in JAX
            if hasattr(tt.exchange, "shard_of"):
                np.testing.assert_array_equal(tt.exchange.shard_of(seen),
                                              jt.exchange.shard_of(seen))
        js, ts = jt.run_round(r, jcum), tt.run_round(r, tcum)
        jcum, tcum = js.cum_time, ts.cum_time
        assert [ex.delta.tau for ex in tt.ex_clients
                if ex is not None and ex.delta is not None] == \
            [ex.delta.tau for ex in jt.ex_clients
             if ex is not None and ex.delta is not None]
        assert ts.embeddings_stored == js.embeddings_stored
        if getattr(tt.exchange, "shard_logs", None) is not None:
            assert [(lg.bytes, lg.rpcs) for lg in tt.exchange.shard_logs] \
                == [(lg.bytes, lg.rpcs) for lg in jt.exchange.shard_logs]
        tol = 1e-6 if r == 0 else (1e-3 if lossy else 1e-4)
        for a, b in zip(tt.params_leaves(), jt.params_leaves()):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=tol)
        assert ts.train_loss == pytest.approx(js.train_loss,
                                              rel=1e-3 if lossy else 1e-4)
    assert tt.growth.applied_epoch == T_SCHED["num_events"]
    assert len(tt.eval_gids) == 1 << T_SCHED["scale"]
    if lossy:
        assert tt._growth_round == 2 and tt._growth_accs_base == 2
    if "pull-frequency" in case:
        pl = tt.exchange._placement
        np.testing.assert_array_equal(pl, jt.exchange._placement)
        unplaced = (seen >= len(pl)) | (pl[np.minimum(seen, len(pl) - 1)]
                                        < 0)
        assert unplaced.any()       # rows that fall back to gid % S


# -- fedsvc --------------------------------------------------------------------

def test_growth_requires_sync_mode(t_base):
    cfg = RunConfig(graph="store:" + t_base, growth=T_SCHED,
                    **dict(T_KW, overrides={"aggregation": "async"}))
    with pytest.raises(ValueError, match="sync"):
        make_coordinator_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="sync"):
        CoordinatorState(num_clients=2, num_rounds=1, mode="async",
                         growth=tdyn.GrowthSchedule(**T_SCHED), device="cpu")


def _deploy(state, make_worker, n=2, timeout=300):
    port = isinstance(state, CoordinatorState)
    with (serve_in_thread if port else jcoord_serve)(state) as coord:
        workers = [make_worker(i, coord.address) for i in range(n)]
        threads = [(run_in_thread if isinstance(w, FedWorker)
                    else jrun_in_thread)(w) for w in workers]
        assert coord.join(timeout=timeout)
        for t in threads:
            t.join(timeout=60)
    return workers


@pytest.mark.parametrize("case", ["D", "OPG-int8"])
def test_port_deployment_grows_like_in_process(t_base, case):
    """Two port workers in threads, growing independently under the
    port coordinator's barrier (OPG with int8 over two embed servers,
    registering the new boundary rows over TCP): accuracies and leaves
    equal to the in-process grown trainer's, bit for bit."""
    over = {} if case == "D" else {"codec": "int8"}
    kw = dict(T_KW, strategy=case.split("-")[0], overrides=over,
              graph="store:" + t_base)
    ref = RunConfig(growth=T_SCHED, **dict(
        kw, overrides=dict(over, num_server_shards=2) if over else over))
    tr = ref.build_trainer(device="cpu")
    want = _accs(tr.train(ref.rounds))
    servers = [] if case == "D" else \
        [embed_serve(3, 32, device="cpu") for _ in range(2)]
    try:
        cfg = RunConfig(growth=T_SCHED,
                        embed_addrs=[f"{h.host}:{h.port}" for h in servers],
                        **kw)
        state = make_coordinator_state(cfg, device="cpu")
        workers = _deploy(state, lambda i, addr: FedWorker(
            cfg, [i], addr, worker_id=f"w{i}", device="cpu"))
    finally:
        for h in servers:
            h.stop()
    assert state.acc_history == want
    for a, b in zip(tr.params_leaves(), state.leaves):
        assert a.tobytes() == np.asarray(b).tobytes()
    for w in workers:
        assert w.trainer.g.num_vertices == 1 << T_SCHED["scale"]
        assert w.trainer.growth.applied_epoch == T_SCHED["num_events"]
        assert [r["round"] for r in w.records] == list(range(cfg.rounds))


def test_jax_coordinator_with_port_workers_grows(t_base):
    """A JAX coordinator (its leaves, its grown evaluation) and port
    workers seeded from the same leaves: the leaves equal the port's
    in-process grown trainer loaded with those leaves, bit for bit."""
    jcfg = JRunConfig(graph="store:" + t_base, growth=T_SCHED, **T_KW)
    harness = JHarness(jcfg)
    init = harness.init_leaves()
    cfg = RunConfig(graph="store:" + t_base, growth=T_SCHED, **T_KW)
    ref = cfg.build_trainer(device="cpu")
    ref.load_leaves(init)
    accs = _accs(ref.train(cfg.rounds))
    state = JCoordState(num_clients=2, num_rounds=cfg.rounds,
                        init_leaves=init, eval_fn=harness.evaluate_leaves,
                        growth=jdyn.GrowthSchedule(**T_SCHED))

    def worker(i, addr):
        tr = cfg.build_trainer(only_clients=[i], device="cpu")
        tr.load_leaves(init)
        return FedWorker(cfg, [i], addr, trainer=tr, worker_id=f"w{i}")

    _deploy(state, worker)
    for a, b in zip(ref.params_leaves(), state.leaves):
        assert a.tobytes() == np.asarray(b).tobytes()
    assert state.acc_history == accs



def test_port_coordinator_with_jax_workers_grows(t_base):
    """A port coordinator seeded with the JAX trainer's leaves and JAX
    workers: leaves equal to the JAX in-process grown trainer's, bit
    for bit."""
    jcfg = JRunConfig(graph="store:" + t_base, growth=T_SCHED, **T_KW)
    ref = jcfg.build_trainer()
    init = ref.params_leaves()
    jaccs = _accs(ref.train(jcfg.rounds))
    harness = EvalHarness(RunConfig(**dataclasses.asdict(jcfg)),
                          device="cpu")
    state = CoordinatorState(num_clients=2, num_rounds=jcfg.rounds,
                             init_leaves=init,
                             eval_fn=harness.evaluate_leaves,
                             growth=tdyn.GrowthSchedule(**T_SCHED),
                             device="cpu")
    _deploy(state, lambda i, addr: JWorker(jcfg, [i], addr,
                                           worker_id=f"w{i}"))
    for a, b in zip(ref.params_leaves(), state.leaves):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert state.acc_history == jaccs

