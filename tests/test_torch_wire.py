"""The port's TCP embedding wire against the JAX package's: every frame
byte-equal to the JAX package's and read by both parsers, the opcode
values equal, the payload blocks equal to the NetworkModel's bytes, the
port's TcpTransport against a port server and each against the JAX
counterpart (gathers bit-equal for every codec, reconnect, fail-fast
checks), the network-model fit, the telemetry scrape in both directions,
and the port trainer over TCP bit-equal to its in-process trainer."""

import dataclasses
import json
import socket

import numpy as np
import pytest
import torch

from repro.core.cost_model import NetworkModel as JNet
from repro.core.cost_model import fit_network_model as jfit
from repro.exchange import codec as jcodec
from repro.exchange import wire as jwire
from repro.exchange.socket_transport import TcpTransport as JTcp
from repro.fedsvc import protocol as jprotocol
from repro.launch.embed_server import serve_in_thread as jserve
from repro.obsv import teleserve as jtele
from repro_torch.core.cost_model import NetworkModel, fit_network_model
from repro_torch.exchange import (ExchangeClient, InProcessTransport,
                                  get_codec, make_transport)
from repro_torch.exchange import wire
from repro_torch.exchange.socket_transport import TcpTransport, parse_address
from repro_torch.fedsvc import protocol
from repro_torch.launch import obs_dump
from repro_torch.launch.embed_server import serve_in_thread
from repro_torch.obsv import teleserve
from repro_torch.obsv.trace import TRACE

torch.set_num_threads(1)

H = 16
CODECS = ["fp32", "fp16", "int8"]


def _rows(n, seed, h=H):
    return (np.random.default_rng(seed).standard_normal((n, h)) * 3) \
        .astype(np.float32)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture
def port_shards():
    handles = [serve_in_thread(3, H, device="cpu") for _ in range(2)]
    yield handles
    for h in handles:
        h.stop()


# -- opcodes and frames -------------------------------------------------------

def test_opcode_values_equal_jax():
    for name in ("REGISTER", "WRITE", "GATHER", "EMBED_STATS",
                 "EMBED_SHUTDOWN", "VGATHER", "METRICS", "TRACE"):
        assert getattr(wire, f"PT_OP_{name}") == getattr(jwire, f"OP_{name}")
    for name in ("HELLO", "GET_MODEL", "PULLED", "WAIT_PULLED", "UPDATE",
                 "COORD_STATS", "COORD_SHUTDOWN"):
        assert getattr(protocol, f"PT_OP_{name}") == \
            getattr(jprotocol, f"OP_{name}")
    assert (wire.STATUS_OK, wire.STATUS_ERR) == (jwire.STATUS_OK,
                                                 jwire.STATUS_ERR)
    assert wire.CODEC_IDS == jwire.CODEC_IDS
    assert wire.MAX_FRAME == jwire.MAX_FRAME


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("n,h", [(0, H), (1, 3), (57, 32)])
def test_blocks_equal_jax_and_the_network_model(codec, n, h):
    """A port block is the JAX block's bytes, is what the NetworkModel
    charges, and parses back (from either package's bytes) to the
    payload the codec decodes to the JAX round trip."""
    x = _rows(n, n + h, h)
    tc, jc = get_codec(codec), jcodec.get_codec(codec)
    blob = wire.encode_block(codec, tc.encode(torch.from_numpy(x)))
    jblob = jwire.encode_block(codec, jc.encode(x))
    assert blob == jblob
    assert len(blob) == wire.payload_nbytes(codec, n, h) == \
        jwire.payload_nbytes(codec, n, h)
    assert len(blob) == NetworkModel().embedding_bytes(
        n, h, 1, bytes_per_scalar=tc.bytes_per_scalar(h))
    for buf in (memoryview(jblob), memoryview(bytearray(blob))):
        back = tc.decode(wire.decode_block(codec, buf, n, h, "cpu"))
        np.testing.assert_array_equal(_np(back), jc.roundtrip(x))
        jback = jwire.decode_block(codec, buf, n, h)
        if codec == "int8":
            got = wire.decode_block(codec, buf, n, h, "cpu")
            for a, b in zip(got, jback):
                np.testing.assert_array_equal(_np(a), b)


def test_request_frames_equal_jax_both_ways():
    gids = np.array([3, 11, 42, 7], np.int64)
    have = np.array([-1, 2, 0, 5], np.int64)
    blocks = [jwire.encode_block("int8", jcodec.get_codec("int8").encode(
        _rows(4, l))) for l in range(2)]
    pairs = [
        (wire.build_register(gids), jwire.build_register(gids)),
        (wire.build_write("int8", gids, blocks),
         jwire.build_write("int8", gids, blocks)),
        (wire.build_gather("fp16", gids, [1, 2]),
         jwire.build_gather("fp16", gids, [1, 2])),
        (wire.build_vgather("fp32", gids, have, [2]),
         jwire.build_vgather("fp32", gids, have, [2])),
        (wire.build_stats(), jwire.build_stats()),
        (wire.build_shutdown(), jwire.build_shutdown()),
    ]
    for ours, theirs in pairs:
        assert ours == theirs
        op, req = wire.parse_request(theirs)
        jop, jreq = jwire.parse_request(ours)
        assert op == jop and set(req) == set(jreq)
        for k, v in req.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, jreq[k])
            elif isinstance(v, memoryview):
                assert bytes(v) == bytes(jreq[k])
            else:
                assert v == jreq[k]
    with pytest.raises(ValueError, match="unknown opcode"):
        wire.parse_request(bytes([99]))


def test_response_frames_equal_jax_both_ways():
    assert wire.build_ok(b"xyz") == jwire.build_ok(b"xyz")
    assert wire.build_err("bad ü") == jwire.build_err("bad ü")
    p = wire.build_stats_payload(3, 32, 1000, 1 << 33)
    assert p == jwire.build_stats_payload(3, 32, 1000, 1 << 33)
    assert wire.parse_stats_payload(p) == jwire.parse_stats_payload(p)
    assert bytes(wire.parse_response(jwire.build_ok(b"ab"))) == b"ab"
    with pytest.raises(RuntimeError, match="boom"):
        wire.parse_response(jwire.build_err("boom"))
    with pytest.raises(RuntimeError, match="boom"):
        jwire.parse_response(wire.build_err("boom"))
    assert wire.frame_nbytes(10) == jwire.frame_nbytes(10)


def test_tensor_lists_equal_jax_both_ways():
    arrays = [np.float32(np.pi).reshape(()),
              np.arange(12, dtype=np.float32).reshape(3, 4),
              np.array([], dtype=np.int64),
              np.nextafter(np.ones((2, 3), np.float32), 0.0),
              np.arange(5, dtype=np.int8)]
    blob = wire.build_tensors(arrays)
    assert blob == jwire.build_tensors(arrays)
    assert len(blob) == wire.tensors_nbytes(arrays) == \
        jwire.tensors_nbytes(arrays)
    for parse in (wire.parse_tensors, jwire.parse_tensors):
        back, off = parse(memoryview(blob))
        assert off == len(blob)
        for a, b in zip(arrays, back):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def test_framing_over_a_socket_pair():
    a, b = socket.socketpair()
    try:
        wire.send_frame(a, b"hello")
        assert jwire.recv_frame(b) == b"hello"
        jwire.send_frame(b, b"x" * 100_000)
        got = wire.recv_frame(a)
        assert isinstance(got, bytearray) and got == b"x" * 100_000
        a.close()
        assert wire.recv_frame(b) is None      # clean EOF at a boundary
    finally:
        b.close()


def test_parse_address_forms():
    assert parse_address(("10.0.0.1", 7040)) == ("10.0.0.1", 7040)
    assert parse_address("10.0.0.1:7040") == ("10.0.0.1", 7040)
    assert parse_address(":7040") == ("127.0.0.1", 7040)


# -- TcpTransport -------------------------------------------------------------

def _push_peek(ex_a, ex_b, seed=1, rounds=2, n=123):
    gids = np.random.default_rng(0).permutation(500)[:n]
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        vals = [rng.standard_normal((n, H)).astype(np.float32)
                for _ in range(2)]
        for ex in (ex_a, ex_b):
            ex.register(gids)
            ex.push(gids, [torch.from_numpy(v) for v in vals]
                    if isinstance(ex, ExchangeClient) else vals)
        for a, b in zip(ex_a.peek(gids), ex_b.peek(gids)):
            np.testing.assert_array_equal(_np(a), _np(b))
    return gids


@pytest.mark.parametrize("codec", CODECS)
def test_port_tcp_equals_in_process(port_shards, codec):
    """push → peek over a live 2-shard port wire, τ-filtered, is
    bit-identical to the in-process transport, and each shard's measured
    payload bytes equal the modelled bytes of its RPCs."""
    tcp = TcpTransport(3, H, [h.address for h in port_shards], codec=codec,
                       device="cpu")
    inp = InProcessTransport(3, H, device="cpu")
    _push_peek(ExchangeClient(tcp, codec, delta_threshold=0.05),
               ExchangeClient(inp, codec, delta_threshold=0.05))
    bps = get_codec(codec).bytes_per_scalar(H)
    for s, lg in enumerate(tcp.wire_logs):
        samples = [r for r in tcp.rpc_samples
                   if r.shard == s and r.op != "register"]
        assert lg.bytes == sum(
            tcp.nets[s].embedding_bytes(r.n_rows, H, r.layers,
                                        bytes_per_scalar=bps)
            for r in samples) > 0
        assert lg.measured_seconds > 0
    assert tcp.num_embeddings_stored == inp.num_embeddings_stored
    tcp.close()


@pytest.mark.parametrize("codec", CODECS)
def test_jax_client_on_port_servers(port_shards, codec):
    """A JAX TcpTransport against port embed servers is bit-identical to
    the port's in-process transport, through both clients."""
    from repro.exchange import ExchangeClient as JClient
    jt = JTcp(3, H, [h.address for h in port_shards], codec=codec)
    _push_peek(JClient(jt, codec, delta_threshold=0.05),
               ExchangeClient(InProcessTransport(3, H, device="cpu"), codec,
                              delta_threshold=0.05))
    jt.close()


@pytest.mark.parametrize("codec", CODECS)
def test_port_client_on_jax_servers(codec):
    jhs = [jserve(3, H), jserve(3, H, device_tables=True)]
    try:
        tcp = TcpTransport(3, H, [h.address for h in jhs], codec=codec,
                           device="cpu")
        _push_peek(ExchangeClient(tcp, codec, error_feedback=True),
                   ExchangeClient(InProcessTransport(3, H, device="cpu"),
                                  codec, error_feedback=True))
        if codec == "int8":            # a raw int8 write is lossy
            return
        # raw gathers and the versioned pull agree too (fresh rows; the
        # values are representable, so the wire is lossless)
        gids = np.arange(600, 1100, 7)
        inp = InProcessTransport(3, H, device="cpu")
        vals = [torch.from_numpy(get_codec(codec).roundtrip(
            torch.from_numpy(_rows(len(gids), l))).numpy())
            for l in range(2)]
        for t in (tcp, inp):
            t.register(gids)
            t.write(gids, vals)
        for a, b in zip(tcp.gather(gids), inp.gather(gids)):
            assert torch.equal(a, b)
        have = np.where(np.arange(len(gids)) % 3 == 0, -1, 1)
        tv, ts, tvals = tcp.gather_versioned(gids, have, [2])
        iv, is_, ivals = inp.gather_versioned(gids, have, [2])
        np.testing.assert_array_equal(tv, iv)
        np.testing.assert_array_equal(ts, is_)
        assert torch.equal(tvals[0], ivals[0])
        tcp.close()
    finally:
        for h in jhs:
            h.stop()


def test_reconnect_after_a_dropped_connection(port_shards):
    tcp = TcpTransport(3, H, [h.address for h in port_shards], codec="int8",
                       device="cpu")
    gids = np.arange(40)
    tcp.register(gids)
    tcp.write(gids, [torch.from_numpy(_rows(40, l)) for l in range(2)])
    before = [v.clone() for v in tcp.gather(gids)]
    for sock in tcp._socks:
        sock.close()                   # the pooled sockets die under it
    after = tcp.gather(gids)
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    tcp.close()


def test_fail_fast_checks(port_shards):
    addrs = [h.address for h in port_shards]
    with pytest.raises(ValueError, match="hidden=16 but"):
        TcpTransport(3, 8, addrs, device="cpu")
    with pytest.raises(ValueError, match="L=3"):
        TcpTransport(4, H, addrs, device="cpu")
    tcp = TcpTransport(3, H, addrs, codec="fp16", device="cpu")
    with pytest.raises(ValueError, match="client codec 'int8'"):
        ExchangeClient(tcp, "int8")
    tcp.register(np.arange(10))
    with pytest.raises(RuntimeError, match=r"gids: 4[0-9], 4"):
        tcp.gather(np.arange(40, 50))
    with pytest.raises(NotImplementedError):
        tcp.gather_quantized(np.arange(4))
    tcp.close()


def test_make_transport_tcp_errors(port_shards):
    addrs = [h.address for h in port_shards]
    with pytest.raises(ValueError, match="needs addrs"):
        make_transport(3, H, kind="tcp", device="cpu")
    with pytest.raises(ValueError, match="num_shards=3 but 2"):
        make_transport(3, H, kind="tcp", num_shards=3, addrs=addrs,
                       device="cpu")
    with pytest.raises(ValueError, match="only apply to kind='tcp'"):
        make_transport(3, H, kind="sharded", num_shards=2, addrs=addrs,
                       device="cpu")
    t = make_transport(3, H, addrs=addrs, codec="int8", device="cpu")
    assert isinstance(t, TcpTransport) and t.wire_is_real
    assert t.codec.name == "int8" and t.num_shards == 2
    t.shutdown_servers()


# -- the network-model fit ----------------------------------------------------

def test_fit_network_model_recovers_and_stays_non_negative():
    true = NetworkModel(bandwidth_bytes_per_s=2e9, rpc_overhead_s=5e-5,
                        per_embedding_overhead_s=2e-8)
    rng = np.random.default_rng(0)
    samples = []
    for _ in range(40):
        n, h = int(rng.integers(1, 5000)), int(rng.choice([8, 32, 128]))
        b = n * h * 4
        t = b / true.bandwidth_bytes_per_s + true.rpc_overhead_s \
            + n * true.per_embedding_overhead_s
        samples.append((b, 1, n, t))
    fit = fit_network_model(samples)
    assert fit.bandwidth_bytes_per_s == pytest.approx(2e9, rel=1e-6)
    assert fit.rpc_overhead_s == pytest.approx(5e-5, rel=1e-6)
    assert fit.per_embedding_overhead_s == pytest.approx(2e-8, rel=1e-6)
    j = jfit(samples, relative=True)
    t = fit_network_model(samples, relative=True)
    assert (t.bandwidth_bytes_per_s, t.rpc_overhead_s,
            t.per_embedding_overhead_s) == (j.bandwidth_bytes_per_s,
                                            j.rpc_overhead_s,
                                            j.per_embedding_overhead_s)
    # a per-embedding cost that would fit negative is dropped, not kept
    neg = [(1000.0 * k, 1, 10.0 * k, 1e-3 + 1e-6 * k - 1e-9 * 10 * k)
           for k in range(1, 20)]
    f = fit_network_model(neg)
    assert f.rpc_overhead_s >= 0 and f.per_embedding_overhead_s >= 0
    assert f.bandwidth_bytes_per_s > 0
    with pytest.raises(ValueError, match=">= 3 samples"):
        fit_network_model(samples[:2])
    jn, tn = JNet(), NetworkModel()
    assert tn.model_transfer_time(1000, bytes_per_scalar=1.25) == \
        jn.model_transfer_time(1000, bytes_per_scalar=1.25)


# -- telemetry ----------------------------------------------------------------

def test_jax_scraper_reads_a_port_embed_server():
    was = TRACE.enabled
    TRACE.enable()
    try:
        with serve_in_thread(3, 8, device="cpu") as h:
            tr = TcpTransport(3, 8, [h.address], device="cpu")
            gids = np.arange(16)
            tr.register(gids)
            tr.write(gids, [torch.from_numpy(_rows(16, 0, 8))] * 2)
            tr.gather(gids)
            with jtele.TelemetryClient(h.address) as c:
                sc = c.scrape("embed0")
            tr.close()
    finally:
        TRACE.enabled = was
    assert sc.pid > 0 and abs(sc.offset_s) < 0.05
    assert sc.metrics["pt_embed.requests"] >= 3
    assert sc.metrics["pt_exchange.latency_s.gather"]["count"] >= 1
    assert any(e[0] == "embed.gather" for e in sc.trace["events"])


def test_port_scraper_reads_a_jax_embed_server():
    with jserve(3, 8) as h:
        jt = JTcp(3, 8, [h.address])
        jt.register(np.arange(8))
        jt.close()
        with teleserve.TelemetryClient(h.address) as c:
            sc = c.scrape("jembed")
            # a data-plane opcode on a telemetry-only port errors cleanly
    assert sc.metrics["embed.requests"] >= 1 and sc.pid > 0
    with teleserve.serve_telemetry() as w:
        with teleserve.TelemetryClient(w.address) as c:
            assert c.scrape("w").pid > 0
            wire.send_frame(c._sock, wire.build_stats())
            with pytest.raises(RuntimeError, match="telemetry-only"):
                wire.parse_response(wire.recv_frame(c._sock))
    assert teleserve.handle_telemetry(wire.build_stats()) is None
    assert teleserve.handle_telemetry(b"") is None


def test_coordinators_scraped_both_ways():
    """A JAX scraper reads a port coordinator's control port and a port
    scraper a JAX coordinator's, with the clock handshake."""
    from repro.fedsvc.coordinator import CoordinatorState as JState
    from repro.fedsvc.coordinator import serve_in_thread as jcoord
    from repro_torch.fedsvc.coordinator import CoordinatorState
    from repro_torch.fedsvc.coordinator import serve_in_thread as coord
    for serve, state, client, name in (
            (coord, CoordinatorState(num_clients=1, num_rounds=1,
                                     device="cpu"),
             jtele.TelemetryClient, "pt_coord.aggregations"),
            (jcoord, JState(num_clients=1, num_rounds=1),
             teleserve.TelemetryClient, "coord.aggregations")):
        with serve(state) as h, client(h.address) as c:
            m, off_m = c.metrics()
            t, off_t = c.trace()
        assert name in m["metrics"]
        assert abs(off_m) < 0.05 and abs(off_t) < 0.05
        assert t["pid"] > 0 and isinstance(t["events"], list)


def test_obs_dump_merges_port_and_jax_endpoints(tmp_path):
    with serve_in_thread(3, 8, device="cpu") as e0, jserve(3, 8) as e1, \
            teleserve.serve_telemetry() as w0, \
            jtele.serve_telemetry() as w1:
        out, mout = tmp_path / "trace.json", tmp_path / "metrics.txt"
        obs_dump.main(["--embed", f"{e0.host}:{e0.port}",
                       "--embed", f"{e1.host}:{e1.port}",
                       "--worker", f"{w0.host}:{w0.port}",
                       "--endpoint", f"jworker={w1.host}:{w1.port}",
                       "--out", str(out), "--metrics-out", str(mout)])
        doc, _ = obs_dump.dump([("embed0", e0.address)])
    meta = [e for e in json.loads(out.read_text())["traceEvents"]
            if e["ph"] == "M"]
    assert len(meta) == 4
    table = mout.read_text()
    for label in ("# embed0", "# embed1", "# worker0", "# jworker"):
        assert label in table
    assert "pt_embed.requests" in table and "embed.requests" in table
    assert doc["displayTimeUnit"] == "ms"


def test_servers_reject_unknown_opcodes_and_bad_writes():
    with serve_in_thread(3, 8, device="cpu") as h:
        s = socket.create_connection(h.address)
        wire.send_frame(s, bytes([200]))
        with pytest.raises(RuntimeError, match="opcode"):
            wire.parse_response(wire.recv_frame(s))
        wire.send_frame(s, wire.build_write("fp32", np.arange(2),
                                            [b"\0" * 64]))
        with pytest.raises(RuntimeError, match="1 layer blocks"):
            wire.parse_response(wire.recv_frame(s))
        s.close()


# -- the trainer over TCP -----------------------------------------------------

@pytest.mark.parametrize("codec,ef", [("int8", False), ("fp16", True)])
def test_trainer_over_tcp_equals_in_process(codec, ef):
    """Two rounds of E over 2 live port shards: accuracies, losses and
    leaves bit-identical to the sharded in-process trainer, and the
    measured ledger populated."""
    from repro_torch.core.federated import FederatedGNNTrainer
    from repro_torch.core.strategies import default_strategies
    from repro_torch.graphs import make_graph
    g = make_graph("reddit", scale=0.05, seed=3)
    base = dataclasses.replace(default_strategies()["E"], codec=codec,
                               error_feedback=ef, num_server_shards=2)
    ref = FederatedGNNTrainer(g, 2, base, batch_size=64, seed=0,
                              device="cpu")
    ref_stats = ref.train(2)
    handles = [serve_in_thread(3, 32, device="cpu") for _ in range(2)]
    try:
        tr = FederatedGNNTrainer(
            g, 2, dataclasses.replace(base, transport="tcp"), batch_size=64,
            seed=0, device="cpu",
            transport_addrs=[h.address for h in handles])
        stats = tr.train(2)
        assert [s.accuracy for s in stats] == \
            [s.accuracy for s in ref_stats]
        assert [s.train_loss for s in stats] == \
            [s.train_loss for s in ref_stats]
        assert stats[-1].embeddings_stored == \
            ref_stats[-1].embeddings_stored > 0
        for a, b in zip(ref.params_leaves(), tr.params_leaves()):
            np.testing.assert_array_equal(a, b)
        wl = tr.exchange.wire_log
        assert wl.rpcs > 0 and wl.bytes > 0 and wl.measured_seconds > 0
        assert tr.exchange.log.rpcs == ref.exchange.log.rpcs
        tr.exchange.close()
    finally:
        for h in handles:
            h.stop()
