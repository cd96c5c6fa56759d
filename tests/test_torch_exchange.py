"""The port's exchange plane against the JAX package's: codecs bit-exact,
the embedding server's register / write / fused int8 surface /
versioned-gather stream giving identical payloads, tables and versions,
the exchange client's peek, push and versioned pull matching, and a
stream of delta / error-feedback pushes giving identical selections,
payloads, shadows, residuals and charges."""

import numpy as np
import pytest
import torch

from repro.core.embedding_server import EmbeddingServer as JServer
from repro.exchange import ExchangeClient as JClient
from repro.exchange import codec as jcodec
from repro.exchange import make_transport as jmake_transport
from repro.kernels import ops as jops
from repro_torch.core.embedding_server import EmbeddingServer as TServer
from repro_torch.exchange import ExchangeClient as TClient
from repro_torch.exchange import codec as tcodec
from repro_torch.exchange import make_transport as tmake_transport

torch.set_num_threads(1)

H = 24


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rows(n, seed):
    x = (np.random.default_rng(seed).standard_normal((n, H)) * 2) \
        .astype(np.float32)
    if n > 2:
        x[1] = 0.0
    return x


@pytest.mark.parametrize("name", ["fp32", "fp16", "int8"])
@pytest.mark.parametrize("n", [0, 1, 37])
def test_codecs_bit_exact(name, n):
    x = _rows(n, n)
    jc, tc = jcodec.get_codec(name), tcodec.get_codec(name)
    assert jc.wire_arrays == tc.wire_arrays
    assert jc.bytes_per_scalar(H) == tc.bytes_per_scalar(H)
    jp, tp = jc.encode(x), tc.encode(torch.from_numpy(x))
    if isinstance(jp, tuple):
        for a, b in zip(jp, tp):
            np.testing.assert_array_equal(_np(b), a)
            assert _np(b).dtype == a.dtype
    else:
        np.testing.assert_array_equal(_np(tp), jp)
        assert _np(tp).dtype == jp.dtype
    np.testing.assert_array_equal(_np(tc.roundtrip(torch.from_numpy(x))),
                                  jc.roundtrip(x))
    zeros = np.zeros((4, H), np.float32)
    np.testing.assert_array_equal(
        _np(tc.roundtrip(torch.from_numpy(zeros))), zeros)
    with pytest.raises(ValueError):
        tcodec.get_codec("bf8")


@pytest.mark.parametrize("device_tables", [False, True])
def test_server_stream_identical(device_tables):
    """One stream of registrations, fused int8 writes, raw writes, fused
    gathers and versioned gathers; the port's server answers exactly as
    the JAX server in either table mode, across capacity growth."""
    rng = np.random.default_rng(11)
    js = JServer(3, H, device_tables=device_tables)
    ts = TServer(3, H, device="cpu")
    have: dict[int, int] = {}
    for step in range(5):
        new = rng.choice(2000, size=150, replace=False)
        js.register(new)
        ts.register(new)
        assert js.num_embeddings_stored == ts.num_embeddings_stored
        gids = rng.choice(new, size=90, replace=False)
        if step % 2 == 0:
            payloads = [jops._np_quantize_int8(_rows(90, 10 * step + l))
                        for l in range(2)]
            js.write_quantized(gids, payloads)
            ts.write_quantized(gids, [(torch.from_numpy(v),
                                       torch.from_numpy(s))
                                      for v, s in payloads])
        else:
            vals = [_rows(90, 10 * step + l) for l in range(2)]
            js.write(gids, vals)
            ts.write(gids, vals)
        ask = rng.choice(new, size=60, replace=False)
        for layers in (None, [2]):
            for (jv, jsc), (tv, tsc) in zip(js.gather_quantized(ask, layers),
                                            ts.gather_quantized(ask, layers)):
                np.testing.assert_array_equal(_np(tv), np.asarray(jv))
                np.testing.assert_array_equal(_np(tsc), np.asarray(jsc))
        np.testing.assert_array_equal(ts.versions(ask), js.versions(ask))
        hv = np.array([have.get(int(g), -1) for g in ask], np.int64)
        jver, jst, jvals = js.gather_if_stale(ask, hv, [1])
        tver, tst, tvals = ts.gather_if_stale(ask, hv, [1])
        np.testing.assert_array_equal(tver, jver)
        np.testing.assert_array_equal(tst, jst)
        np.testing.assert_array_equal(_np(tvals[0]), np.asarray(jvals[0]))
        have.update({int(g): int(v) for g, v in zip(ask, tver)})
    every = np.nonzero(js._gid2row >= 0)[0]
    for a, b in zip(js.gather(every), ts.gather(every)):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    assert ts._cap >= 750 and ts._reallocs >= 2
    with pytest.raises(KeyError, match="unregistered"):
        ts.gather(np.array([5000]))


def test_load_rows_restores_a_snapshot():
    js = JServer(3, H)
    gids = np.array([7, 3, 900, 41])
    js.register(gids)
    js.write(gids, [_rows(4, 1), _rows(4, 2)])
    js.write(gids[:2], [_rows(2, 3), _rows(2, 4)])
    snap = np.nonzero(js._gid2row >= 0)[0]
    rows = js._gid2row[snap]
    ts = TServer(3, H, device="cpu")
    ts.load_rows(snap, js._ver[rows], [b[rows] for b in js._bufs])
    np.testing.assert_array_equal(ts.versions(gids), js.versions(gids))
    for a, b in zip(js.gather(gids), ts.gather(gids)):
        np.testing.assert_array_equal(_np(b), a)


@pytest.mark.parametrize("codec", ["fp32", "int8"])
@pytest.mark.parametrize("device_tables", [False, True])
def test_client_matches(codec, device_tables):
    jt = jmake_transport(3, H, kind="inprocess", device_tables=device_tables)
    tt = tmake_transport(3, H, device="cpu")
    jc, tc = JClient(jt, codec), TClient(tt, codec)
    gids = np.arange(0, 400, 3)
    jc.register(gids)
    tc.register(gids)
    vals = [_rows(len(gids), 20), _rows(len(gids), 21)]
    jplan = jc.plan_push(gids, vals)
    tplan = tc.plan_push(gids, [torch.from_numpy(v) for v in vals])
    assert tplan.transfer_time == jplan.transfer_time
    for a, b in zip(jplan.layer_values, tplan.layer_values):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    assert jc.apply_push(jplan) == tc.apply_push(tplan)
    ask = gids[::4]
    for a, b in zip(jc.peek(ask), tc.peek(ask)):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    assert jc.pull_cost(ask) == tc.pull_cost(ask)
    have = np.where(np.arange(len(ask)) % 3 == 0, -1, 1)
    jv, js_, jvals, jtime = jc.pull_versioned(ask, have, [2])
    tv, ts_, tvals, ttime = tc.pull_versioned(ask, have, [2])
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ts_, js_)
    np.testing.assert_array_equal(_np(tvals[0]), np.asarray(jvals[0]))
    assert ttime == jtime
    jlog, tlog = jt.log, tt.log
    assert (jlog.bytes, jlog.rpcs, jlog.embeddings) == \
        (tlog.bytes, tlog.rpcs, tlog.embeddings)
    assert tlog.seconds == pytest.approx(jlog.seconds, rel=1e-12)


def test_training_knobs_wait_for_the_training_slice():
    """The training knobs are ported: τ and EF build their host-side
    trackers.  ``make_transport`` refuses a TCP wire without addresses,
    a shard count other than the address count, and addresses for
    another kind, with the JAX package's ValueErrors."""
    tt = tmake_transport(3, H, device="cpu")
    c = TClient(tt, "int8", delta_threshold=0.1, error_feedback=True)
    assert c.delta.tau == 0.1 and c.delta.layers == 2
    assert c.ef.max_abs_residual == 0.0
    with pytest.raises(ValueError):
        TClient(tt, "int8", delta_threshold=-1.0)
    for kw in (dict(kind="tcp"), dict(kind="tcp", num_shards=3,
                                      addrs=[":1", ":2"]),
               dict(kind="sharded", num_shards=2, addrs=[":1", ":2"])):
        with pytest.raises(ValueError) as ours:
            tmake_transport(3, H, device="cpu", **kw)
        with pytest.raises(ValueError) as theirs:
            jmake_transport(3, H, **kw)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("codec", ["fp32", "int8"])
@pytest.mark.parametrize("tau,ef", [(0.05, False), (0.05, True),
                                    (None, True), (0.0, False)])
def test_delta_and_error_feedback_stream(codec, tau, ef):
    """A bootstrap push then three plan/apply pushes in which some rows
    drift a little and some a lot; a plan abandoned in the middle leaves
    no trace; dynamic pulls charge alike."""
    jt = jmake_transport(3, H, kind="inprocess")
    tt = tmake_transport(3, H, device="cpu")
    kw = dict(delta_threshold=tau, error_feedback=ef)
    jc, tc = JClient(jt, codec, **kw), TClient(tt, codec, **kw)
    gids = np.arange(0, 600, 5)
    n = len(gids)
    jc.register(gids)
    tc.register(gids)
    rng = np.random.default_rng(4)
    vals = [_rows(n, 30), _rows(n, 31)]
    for step in range(4):
        if step:
            drift = np.where(rng.random(n) < 0.3, 0.5, 0.01)[:, None]
            vals = [(v + drift * rng.standard_normal(v.shape))
                    .astype(np.float32) for v in vals]
        if step == 2:                       # abandoned plan: no side effect
            tc.plan_push(gids, [torch.from_numpy(v) for v in vals])
            jc.plan_push(gids, vals)
        jplan = jc.plan_push(gids, vals)
        tplan = tc.plan_push(gids, [torch.from_numpy(v) for v in vals])
        np.testing.assert_array_equal(tplan.global_ids, jplan.global_ids)
        assert (tplan.n_selected, tplan.n_total) == \
            (jplan.n_selected, jplan.n_total)
        assert tplan.transfer_time == jplan.transfer_time
        for a, b in zip(jplan.layer_values, tplan.layer_values):
            np.testing.assert_array_equal(_np(b), np.asarray(a))
        for a, b in zip(jplan.raw_values, tplan.raw_values):
            np.testing.assert_array_equal(_np(b), np.asarray(a))
        if codec == "int8":
            for v, (q, sc) in zip(jplan.raw_values, tplan.payloads):
                wq, ws = jops._np_quantize_int8(np.asarray(v, np.float32))
                np.testing.assert_array_equal(_np(q), wq)
                np.testing.assert_array_equal(_np(sc), ws)
        assert jc.apply_push(jplan) == tc.apply_push(tplan)
        if tau is not None:
            assert tc.delta.history == jc.delta.history
            np.testing.assert_array_equal(tc.delta._shadow, jc.delta._shadow)
        if ef:
            np.testing.assert_array_equal(tc.ef._live, jc.ef._live)
            assert tc.ef.max_abs_residual == jc.ef.max_abs_residual
    if tau == 0.05:
        assert 0 < tc.delta.history[-1][0] < n
    for a, b in zip(jc.peek(gids), tc.peek(gids)):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    assert jc.dynamic_pull(gids[:7]) == tc.dynamic_pull(gids[:7])
    jlog, tlog = jt.log, tt.log
    assert (jlog.bytes, jlog.rpcs, jlog.embeddings) == \
        (tlog.bytes, tlog.rpcs, tlog.embeddings)
    assert tlog.seconds == pytest.approx(jlog.seconds, rel=1e-12)
    assert tt.num_embeddings_stored == jt.num_embeddings_stored


# -- the sharded transport ------------------------------------------------------
#
# Each test runs the JAX package's ShardedTransport (numpy tables) and the
# port's (tables on the CPU here) on the same inputs.  Held exactly: values,
# int8 payloads, versions, the gid → row maps of every shard, the placement
# and pull tallies, and every shard log's (bytes, RPCs, embeddings); the
# modelled seconds within 1e-12 relative (the same float64 sums).

def _logs(tr):
    return [(lg.bytes, lg.rpcs, lg.embeddings) for lg in tr.shard_logs]


def _same_logs(jt, tt):
    assert _logs(tt) == _logs(jt)
    for a, b in zip(jt.shard_logs, tt.shard_logs):
        assert b.seconds == pytest.approx(a.seconds, rel=1e-12)


def _fill(tr, gids, seed, layers=2):
    vals = [_rows(len(gids), seed + l) for l in range(layers)]
    tr.register(gids)
    tr.write(gids, vals)
    return vals


def test_server_forget_leaves_holes():
    """``forget`` drops registrations and leaves holes; a later register
    takes fresh rows past them, whose versions start at 0 as in JAX."""
    js, ts = JServer(3, H), TServer(3, H, device="cpu")
    gids = np.arange(0, 60, 3)
    for s in (js, ts):
        s.register(gids)
        s.write(gids, [_rows(len(gids), 1), _rows(len(gids), 2)])
        s.forget(np.array([3, 9, 9, 10_000, 57]))
        s.register(np.array([9, 200]))
    np.testing.assert_array_equal(ts._gid2row[:201], js._gid2row[:201])
    assert ts._next_row == js._next_row == len(gids) + 2
    assert ts.num_embeddings_stored == js.num_embeddings_stored
    keep = np.array([0, 6, 9, 54, 200])
    np.testing.assert_array_equal(ts.versions(keep), js.versions(keep))
    np.testing.assert_array_equal(ts.versions(keep), [1, 1, 0, 1, 0])
    for a, b in zip(js.gather(keep[:2]), ts.gather(keep[:2])):
        np.testing.assert_array_equal(_np(b), a)
    with pytest.raises(KeyError, match="unregistered"):
        ts.gather(np.array([3]))
    assert ts.memory_bytes() == 2 * ts._cap * H * 4


def test_sharded_gather_matches_inprocess():
    """JAX ``test_exchange.py``'s sharded-vs-single gather, on both
    packages, plus the fused int8 pull: the same values and payloads
    from the port's 4 shards, its single server and JAX's 4 shards."""
    gids = np.random.default_rng(1).permutation(500)[:123]
    single = tmake_transport(3, H, device="cpu")
    sharded = tmake_transport(3, H, num_shards=4, device="cpu")
    jsharded = jmake_transport(3, H, num_shards=4)
    assert type(sharded).__name__ == type(jsharded).__name__ \
        == "ShardedTransport"
    vals = _fill(single, gids, 5)
    _fill(sharded, gids, 5)
    _fill(jsharded, gids, 5)
    perm = np.random.default_rng(2).permutation(len(gids))
    ask = gids[perm]
    for a, b, c, v in zip(single.gather(ask), sharded.gather(ask),
                          jsharded.gather(ask), vals):
        np.testing.assert_array_equal(_np(b), _np(a))
        np.testing.assert_array_equal(_np(b), c)
        np.testing.assert_array_equal(_np(b), v[perm])
    for a, b, c in zip(single.gather_quantized(ask, [2, 1]),
                       sharded.gather_quantized(ask, [2, 1]),
                       jsharded.gather_quantized(ask, [2, 1])):
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(_np(y), _np(x))
            np.testing.assert_array_equal(_np(y), z)
    assert sharded.num_embeddings_stored == \
        jsharded.num_embeddings_stored == single.num_embeddings_stored
    assert sharded.memory_bytes() == sum(s.memory_bytes()
                                         for s in sharded.shards)


def test_sharded_traffic_split_and_parallel_time():
    gids = np.arange(400)
    single = tmake_transport(3, 32, device="cpu")
    sharded = tmake_transport(3, 32, kind="sharded", num_shards=4,
                              device="cpu")
    jsharded = jmake_transport(3, 32, kind="sharded", num_shards=4)
    for t in (single, sharded, jsharded):
        t.register(gids)
        assert t.account(gids, 2, 4.0) == \
            pytest.approx(t.transfer_time(gids, 2, 4.0), rel=1e-12)
    _same_logs(jsharded, sharded)
    logs = sharded.shard_logs
    assert len(logs) == 4 and all(lg.bytes > 0 for lg in logs)
    assert sum(lg.bytes for lg in logs) == single.log.bytes
    assert sharded.log.bytes == single.log.bytes
    assert sharded.log.rpcs == 4 and single.log.rpcs == 1
    assert sharded.transfer_time(gids, 2, 4.0) < \
        single.transfer_time(gids, 2, 4.0)
    assert sharded.transfer_time(gids, 2, 4.0) == \
        jsharded.transfer_time(gids, 2, 4.0)


def test_heterogeneous_shard_links():
    from repro.core.cost_model import NetworkModel as JNet
    from repro_torch.core.cost_model import NetworkModel as TNet

    kw = dict(bandwidth_bytes_per_s=1e6, rpc_overhead_s=0.1)
    tr = tmake_transport(3, 32, num_shards=2, nets=[TNet(**kw), TNet()],
                         device="cpu")
    jt = jmake_transport(3, 32, num_shards=2, nets=[JNet(**kw), JNet()])
    gids = np.arange(100)
    for t in (tr, jt):
        t.register(gids)
    t_port, t_jax = tr.account(gids, 2, 4.0), jt.account(gids, 2, 4.0)
    assert t_port == t_jax
    assert t_port == pytest.approx(tr.shard_logs[0].seconds)
    assert tr.shard_logs[0].seconds > tr.shard_logs[1].seconds
    _same_logs(jt, tr)
    with pytest.raises(ValueError, match="one per shard"):
        tmake_transport(3, 32, num_shards=3, nets=[TNet()] * 2,
                        device="cpu")


def test_rebalance_without_log_keeps_hash_placement():
    ids = np.array([3, 7, 11])
    for tr in (jmake_transport(3, 8, num_shards=4),
               tmake_transport(3, 8, num_shards=4, device="cpu")):
        assert tr.rebalance_by_pulls() is None
        np.testing.assert_array_equal(tr.shard_of(ids), ids % 4)
        # pull tallies are off unless rebalancing asked for them
        tr.register(ids)
        tr.gather(ids)
        tr.gather_quantized(ids)
        assert not np.any(tr._pull_counts)


def test_rebalance_migrates_rows():
    """Skewed pulls, then a rebalance: the placement, the pull tallies,
    every shard's gid → row map and versions equal JAX's; migrated rows
    read back equal, fp32 and int8; a fresh register after the
    migration takes a row past the holes."""
    sides = [jmake_transport(3, 4, num_shards=2),
             tmake_transport(3, 4, num_shards=2, device="cpu")]
    ids = np.arange(10)
    vals = [np.arange(40, dtype=np.float32).reshape(10, 4) * (l + 1)
            for l in range(2)]
    before = []
    for t in sides:
        t.track_pulls = True
        t.register(ids)
        t.write(ids, vals)
        before.append([_np(v) for v in t.gather(ids)])
        for _ in range(3):
            t.gather(ids[:4])
        t.gather_quantized(ids[5:7])
    (jt, tt) = sides
    np.testing.assert_array_equal(tt._pull_counts, jt._pull_counts)
    jp, tp = jt.rebalance_by_pulls(), tt.rebalance_by_pulls()
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tt._placement, jt._placement)
    assert np.any(tt.shard_of(ids) != ids % 2)
    for js, ts in zip(jt.shards, tt.shards):
        np.testing.assert_array_equal(ts._gid2row[:10], js._gid2row[:10])
    np.testing.assert_array_equal(
        np.concatenate([s.versions(ids[tt.shard_of(ids) == k])
                        for k, s in enumerate(tt.shards)]),
        np.concatenate([s.versions(ids[jt.shard_of(ids) == k])
                        for k, s in enumerate(jt.shards)]))
    for t, b in zip(sides, before):
        for x, y in zip(b, t.gather(ids)):
            np.testing.assert_array_equal(_np(y), x)
    for (a, b), (c, d) in zip(jt.gather_quantized(ids),
                              tt.gather_quantized(ids)):
        np.testing.assert_array_equal(_np(c), a)
        np.testing.assert_array_equal(_np(d), b)
    for t in sides:
        t.register(np.array([100]))
        t.write(np.array([100]), [np.full((1, 4), 9.0, np.float32)] * 2)
        np.testing.assert_array_equal(_np(t.gather(np.array([100]))[0]),
                                      np.full((1, 4), 9.0, np.float32))
    assert tt.num_embeddings_stored == jt.num_embeddings_stored


@pytest.mark.parametrize("num_shards", [1, 3, 4])
def test_sharded_stream_identical(num_shards):
    """One stream of registrations, fused int8 pushes, raw writes, fused
    pulls, versioned gathers and pull charges on S shards (at S = 4 one
    shard owns no id): payloads, versions, stale positions and every
    shard's log equal JAX's."""
    rng = np.random.default_rng(20 + num_shards)
    pool = np.arange(3000)
    if num_shards == 4:
        pool = pool[pool % 4 != 2]          # shard 2 stays empty
    jt = jmake_transport(3, H, kind="sharded", num_shards=num_shards)
    tt = tmake_transport(3, H, kind="sharded", num_shards=num_shards,
                         device="cpu")
    have: dict[int, int] = {}
    for step in range(4):
        new = rng.choice(pool, size=200, replace=False)
        jt.register(new)
        tt.register(new)
        gids = rng.choice(new, size=120, replace=False)
        if step % 2 == 0:
            payloads = [jops._np_quantize_int8(_rows(120, 40 + step + l))
                        for l in range(2)]
            jt.write_quantized(gids, payloads)
            tt.write_quantized(gids, [(torch.from_numpy(v),
                                       torch.from_numpy(s))
                                      for v, s in payloads])
        else:
            vals = [_rows(120, 50 + step + l) for l in range(2)]
            jt.write(gids, vals)
            tt.write(gids, [torch.from_numpy(v) for v in vals])
        ask = rng.choice(new, size=90)
        for (a, b), (c, d) in zip(jt.gather_quantized(ask),
                                  tt.gather_quantized(ask)):
            np.testing.assert_array_equal(_np(c), a)
            np.testing.assert_array_equal(_np(d), b)
        have_v = np.array([have.get(int(g), -1) for g in ask])
        jv, jst, jvals = jt.gather_versioned(ask, have_v, [1])
        tv, tst, tvals = tt.gather_versioned(ask, have_v, [1])
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tst, jst)
        np.testing.assert_array_equal(_np(tvals[0]), jvals[0])
        have.update({int(g): int(v) for g, v in zip(ask, tv)})
        for t in (jt, tt):
            t.account(ask, 2, 1.125)
            t.account(gids, 2, 1.125)
    _same_logs(jt, tt)
    if num_shards == 4:
        assert tt.shard_logs[2].rpcs == 0
        assert tt.shards[2].num_embeddings_stored == 0
    assert tt.num_embeddings_stored == jt.num_embeddings_stored


@pytest.mark.parametrize("kw", [dict(kind="inprocess", num_shards=2),
                                dict(kind="bogus"), dict(kind="tcp")])
def test_make_transport_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError):
        jmake_transport(3, H, **kw)
    with pytest.raises(ValueError):
        tmake_transport(3, H, device="cpu", **kw)


@pytest.mark.parametrize("n,L", [(3, 3), (17, 4)])
def test_server_push_pull_match_jax(n, L):
    """``EmbeddingServer.push`` / ``pull``: the same rows back, the same
    modelled seconds and the same log as the JAX server's."""
    ids = np.arange(n) * 3 + 1
    vals = [_rows(n, 40 + l) for l in range(L - 1)]
    js, ts = JServer(L, H), TServer(L, H, device="cpu")
    for s in (js, ts):
        s.register(ids)
    assert ts.push(ids, vals) == js.push(ids, vals) > 0
    perm = np.random.default_rng(n).permutation(n)
    (tg, tt), (jg, jt) = ts.pull(ids[perm]), js.pull(ids[perm])
    assert tt == jt > 0
    for a, b, v in zip(tg, jg, vals):
        np.testing.assert_array_equal(_np(a), b)
        np.testing.assert_array_equal(_np(a), v[perm])
    (t1, _), (j1, _) = ts.pull(ids, layers=[L - 1]), \
        js.pull(ids, layers=[L - 1])
    np.testing.assert_array_equal(_np(t1[0]), j1[0])
    assert ts.pull(ids, layers=[])[1] == js.pull(ids, layers=[])[1] == 0.0
    assert ts.push(ids[:0], [v[:0] for v in vals]) == 0.0
    for f in ("bytes", "rpcs", "embeddings", "seconds"):
        assert getattr(ts.log, f) == getattr(js.log, f), f
    assert ts.log.rpcs == 3
    with pytest.raises(ValueError, match="layer blocks"):
        ts.push(ids, vals[:-1])
