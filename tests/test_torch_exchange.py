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
    trackers.  Transports other than in-process still wait."""
    tt = tmake_transport(3, H, device="cpu")
    c = TClient(tt, "int8", delta_threshold=0.1, error_feedback=True)
    assert c.delta.tau == 0.1 and c.delta.layers == 2
    assert c.ef.max_abs_residual == 0.0
    with pytest.raises(ValueError):
        TClient(tt, "int8", delta_threshold=-1.0)
    with pytest.raises(ValueError):
        tmake_transport(3, H, kind="tcp", device="cpu")


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
