"""Serving over TCP on the port, held to the JAX package.

The frames: ``PT_OP_PREDICT`` / ``PT_OP_SSTATS`` equal JAX's ``OP_*``
values, every PREDICT, SSTATS and shutdown frame and every reply
payload is byte-equal to the JAX builders', and each package's parser
reads the other's frames.

The frontend on the CPU: one JAX-trained state (arxiv at scale 0.1, 2
clients, GraphConv L = 2 hidden 8, Strategy E, one round) is served by
a JAX plane and by a port plane loaded from the JAX parameters and
server rows, each behind its own frontend.  The port frontend's
threshold-1.0 answers equal ``offline_predict``; a JAX client and a port
client get the same bytes from either frontend; the two frontends agree
(predictions and depths equal, confidences within 1e-4, as
``tests/test_torch_serving.py`` holds the planes).  Concurrent clients
coalesce into shared forwards; SSTATS counts what was served and
carries only ``pt_gnnserve.*`` metrics; the telemetry scrape of the
frontend (both packages' scrapers, ``obs_dump``) counts the PREDICT
RPCs.  ``launch/gnn_serve --device cpu`` over a store built by
``launch/build_store`` answers as the in-process plane of the same
RunConfig, shuts down on a JAX client's shutdown frame and exits 0.

Over TCP embedding servers: an int8 ``PT_OP_VGATHER`` (the serving
cache's refresh; the port's servers encode its stale rows with the
fused gather + encode) equals the same RPCs against JAX servers, and a
plane built by ``build_plane_from_cfg`` with ``embed_addrs`` answers
every query as the same RunConfig served in process, bit for bit.
"""

import collections
import dataclasses
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro.core import FederatedGNNTrainer, Strategy
from repro.gnnserve import build_serving as jbuild_serving
from repro.gnnserve import wire as jwire
from repro.gnnserve.frontend import GnnServeClient as JClient
from repro.gnnserve.frontend import serve_in_thread as jserve
from repro.graphs import make_graph as jmake_graph
from repro.obsv import teleserve as jteleserve
from repro_torch.core.federated import setup_exchange
from repro_torch.exchange import make_transport
from repro_torch.fedsvc.runtime import RunConfig
from repro_torch.gnnserve import GnnServeClient, build_serving, serve_in_thread
from repro_torch.gnnserve import wire
from repro_torch.graphs import make_client_shards, make_graph
from repro_torch.launch import gnn_serve, obs_dump
from repro_torch.models.gnn import from_jax_leaves
from repro_torch.obsv import teleserve
from repro_torch.obsv.metrics import REGISTRY

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
L, HIDDEN = 2, 8
PLANE_KW = dict(cache_rows=64, serve_fanout=4, batch_size=16)
CONF_TOL = 1e-4


# -- the frames ---------------------------------------------------------------

def test_opcode_values_equal_jax():
    assert (wire.PT_OP_PREDICT, wire.PT_OP_SSTATS,
            wire.PT_OP_EMBED_SHUTDOWN) == \
        (jwire.OP_PREDICT, jwire.OP_SSTATS, jwire.OP_EMBED_SHUTDOWN)


@pytest.mark.parametrize("n", [0, 1, 57])
def test_frames_equal_jax_both_ways(n):
    rng = np.random.default_rng(n)
    vids = rng.integers(0, 1 << 40, n)
    thr = rng.random(n).astype(np.float32)
    for ours, theirs in ((wire.build_predict(vids, thr),
                          jwire.build_predict(vids, thr)),
                         (wire.build_sstats(), jwire.build_sstats()),
                         (wire.build_shutdown(), jwire.build_shutdown())):
        assert ours == theirs
        for parse in (wire.parse_serve_request, jwire.parse_serve_request):
            (op_a, req_a), (op_b, req_b) = parse(ours), \
                jwire.parse_serve_request(theirs)
            assert op_a == op_b and sorted(req_a) == sorted(req_b)
            for k in req_a:
                np.testing.assert_array_equal(req_a[k], req_b[k])
    preds = rng.integers(0, 40, n).astype(np.int32)
    confs = rng.random(n).astype(np.float32)
    depths = rng.integers(1, 4, n).astype(np.int32)
    payload = wire.build_predict_payload(preds, confs, depths)
    assert payload == jwire.build_predict_payload(preds, confs, depths)
    for parse in (wire.parse_predict_payload, jwire.parse_predict_payload):
        for got, want in zip(parse(payload), (preds, confs, depths)):
            np.testing.assert_array_equal(got, want)
    stats = {"served": n, "exits_by_depth": {"1": n}, "metrics": {}}
    assert wire.build_stats_payload(stats) == \
        jwire.build_stats_payload(stats)
    assert wire.parse_stats_payload(jwire.build_stats_payload(stats)) == \
        stats
    for parse in (wire.parse_serve_request, jwire.parse_serve_request):
        with pytest.raises(ValueError, match="opcode"):
            parse(bytes([200]))


# -- one trained state, served by both packages -------------------------------

@pytest.fixture(scope="module")
def trained():
    g = jmake_graph("arxiv", scale=0.1, seed=7)
    tr = FederatedGNNTrainer(g, 2, Strategy("E"), num_layers=L,
                             hidden=HIDDEN, fanout=4, batch_size=16,
                             epochs_per_round=1, seed=0)
    tr.pretrain_round()
    tr.run_round(0, 0.0)
    return tr, tr.export_for_serving()


def _port_bundle(tr):
    """The port's model, shards and an in-process transport holding the
    JAX server's rows and versions (after its export)."""
    srv = tr.exchange.server
    gids = np.nonzero(srv._gid2row >= 0)[0]
    rows = srv._gid2row[gids]
    tt = make_transport(L, HIDDEN, device="cpu")
    tt.server.load_rows(gids, srv._ver[rows].copy(),
                        [np.asarray(b)[rows, : srv.hidden]
                         for b in srv._bufs])
    shards = make_client_shards(make_graph("arxiv", scale=0.1, seed=7),
                                tr.part)
    setup_exchange(shards, tr.part, tt)
    return {"model": from_jax_leaves(tr.params_leaves(), "graphconv",
                                     device="cpu"),
            "conv": "graphconv", "num_layers": L, "hidden": HIDDEN,
            "part": np.asarray(tr.part),
            "shards": {sh.client_id: sh for sh in shards},
            "transport": tt, "codec": "fp32"}


@pytest.fixture(scope="module")
def bundles(trained):
    tr, jbundle = trained
    return _port_bundle(tr), jbundle


def _offline(plane, vids) -> np.ndarray:
    """Each vertex's full-depth argmax, per owner shard, in engine-batch
    chunks (no batcher or early-exit state shared with serving)."""
    by_owner = collections.defaultdict(list)
    for v in sorted(set(int(v) for v in vids)):
        by_owner[int(plane.part[v])].append(v)
    ref = {}
    for ci, vs in by_owner.items():
        eng = plane.engines[ci]
        for i in range(0, len(vs), eng.batch_size):
            chunk = vs[i: i + eng.batch_size]
            preds = eng.offline_predict(
                np.array([eng.local_id(v) for v in chunk], np.int64))
            ref.update(zip(chunk, (int(p) for p in preds)))
    return np.array([ref[int(v)] for v in vids], np.int32)


def test_frontends_answer_alike_across_packages(bundles):
    tbundle, jbundle = bundles
    tplane = build_serving(tbundle, device="cpu", **PLANE_KW)
    jplane = jbuild_serving(jbundle, **PLANE_KW)
    rng = np.random.default_rng(4)
    vids = rng.integers(0, len(tplane.part), 60)
    vids[::7] = vids[0]                   # coalesced duplicates
    ones = np.ones(len(vids), np.float32)
    mixed = rng.choice([1.0, 0.6, 0.3], len(vids)).astype(np.float32)
    with serve_in_thread(tplane) as th, jserve(jplane) as jh:
        answers = {}
        for front, addr in (("port", th.address), ("jax", jh.address)):
            for cname, cls in (("port", GnnServeClient), ("jax", JClient)):
                with cls(addr) as cli:
                    answers[front, cname] = (cli.predict(vids, ones),
                                             cli.predict(vids, mixed))
    for front in ("port", "jax"):
        for a, b in zip(answers[front, "port"], answers[front, "jax"]):
            for x, y in zip(a, b):
                assert x.tobytes() == y.tobytes()
    (tp, tc, td), _ = answers["port", "port"]
    (jp, jc, jd), _ = answers["jax", "jax"]
    np.testing.assert_array_equal(tp, _offline(tplane, vids))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(td, np.full(len(vids), L))
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=CONF_TOL)
    assert np.all((tc > 0.0) & (tc <= 1.0))
    assert tplane.stats()["served"] == 4 * len(vids)


def test_concurrent_clients_coalesce(bundles):
    """Four clients' PREDICTs queue before the driver steps (the plane
    reports no work until all of them are in), so they share forwards:
    one per shard per batch of the union, fewer than one batch set an
    RPC, with every request answered once and as ``offline_predict``."""
    plane = build_serving(bundles[0], device="cpu", depth_schedule=[L],
                          **PLANE_KW)
    rng = np.random.default_rng(9)
    per = [rng.integers(0, len(plane.part), 24) for _ in range(4)]
    total = sum(len(v) for v in per)
    pending = plane.pending
    plane.pending = lambda: pending() if plane._next_rid >= total else 0
    out: dict = {}

    def query(i):
        with GnnServeClient(h.address) as cli:
            out[i] = cli.predict(per[i])

    with serve_in_thread(plane) as h:
        threads = [threading.Thread(target=query, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        stats = GnnServeClient(h.address).stats()
    assert sorted(out) == [0, 1, 2, 3]
    for i in range(4):
        np.testing.assert_array_equal(out[i][0], _offline(plane, per[i]))

    def batches(vid_sets):
        owners = [np.bincount(plane.part[v], minlength=2) for v in vid_sets]
        return int(sum(-(-n // PLANE_KW["batch_size"])
                       for o in owners for n in o))

    assert stats["served"] == total
    assert stats["forwards"] == batches([np.concatenate(per)])
    assert stats["forwards"] < batches(per)


def test_sstats_and_the_telemetry_scrape(bundles):
    plane = build_serving(bundles[0], device="cpu", **PLANE_KW)
    before = REGISTRY.snapshot("pt_gnnserve.").get(
        "pt_gnnserve.predict_rpcs", 0)
    vids = np.arange(0, 40, 3)
    with serve_in_thread(plane) as h:
        with GnnServeClient(h.address) as cli:
            for _ in range(3):
                cli.predict(vids)
            stats = cli.stats()
        with teleserve.TelemetryClient(h.address) as c:
            ours = c.scrape("serve")
        with jteleserve.TelemetryClient(h.address) as c:
            theirs = c.scrape("serve")
        doc, table = obs_dump.dump([("serve", h.address)])
    assert stats["served"] == 3 * len(vids)
    assert "cache_hit_rate" in stats and stats["metrics"]
    assert all(k.startswith("pt_gnnserve.") for k in stats["metrics"])
    assert "pt_gnnserve.cache.hits" in stats["metrics"]
    assert stats["metrics"]["pt_gnnserve.predict_rpcs"] - before == 3
    for sc in (ours, theirs):
        assert sc.pid == os.getpid()
        assert sc.metrics["pt_gnnserve.predict_rpcs"] - before == 3
    assert [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert "pt_gnnserve.predict_rpcs" in table


def test_error_frames(bundles):
    plane = build_serving(bundles[0], device="cpu", **PLANE_KW)
    with serve_in_thread(plane) as h:
        with GnnServeClient(h.address) as cli:
            with pytest.raises(RuntimeError):
                cli.predict([len(plane.part) + 5])
            with pytest.raises(RuntimeError, match="opcode"):
                cli._rpc(bytes([200]))
            with pytest.raises(RuntimeError, match="bad request"):
                cli._rpc(wire.build_predict(np.arange(4),
                                            np.ones(4, np.float32))[:-3])
            # the connection still answers after error frames
            preds, _, _ = cli.predict([1, 2])
        np.testing.assert_array_equal(preds, _offline(plane, [1, 2]))
        JClient(h.address).shutdown()
        assert h.stopped


# -- the launchers as processes -----------------------------------------------

def _free_env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu"}


def test_gnn_serve_launcher_over_a_store(tmp_path):
    store = tmp_path / "store"
    subprocess.run([sys.executable, "-m", "repro_torch.launch.build_store",
                    "--out", str(store), "--preset", "arxiv", "--scale",
                    "0.1", "--graph-seed", "7", "--seed", "0",
                    "--clients", "2"], env=_free_env(), check=True,
                   capture_output=True, timeout=120)
    flags = ["--graph", f"store:{store}", "--clients", "2", "--strategy",
             "E", "--rounds", "1", "--num-layers", str(L), "--hidden",
             str(HIDDEN), "--epochs", "1", "--batch-size", "16",
             "--fanout", "4", "--seed", "0"]
    serve = ["--serve-fanout", "4", "--serve-batch", "16",
             "--cache-rows", "64", "--depth-schedule", f"1,{L}"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.gnn_serve", "--port", "0",
         "--device", "cpu", *serve, *flags], env=_free_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("gnn_serve listening on"):
                break
        assert lines and lines[-1].startswith("gnn_serve listening on"), \
            "".join(lines)
        addr = lines[-1].split()[3]
        vids = np.arange(0, 600, 7)
        with GnnServeClient(addr) as cli:
            preds, _, depths = cli.predict(vids)
            assert cli.stats()["served"] == len(vids)
        JClient(addr).shutdown()
        rest, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    assert proc.returncode == 0, rest
    assert '"served": %d' % len(vids) in rest.splitlines()[-1]
    # the same RunConfig in process: the same answers
    cfg = RunConfig(graph=f"store:{store}", num_clients=2, strategy="E", rounds=1,
             num_layers=L, hidden=HIDDEN, epochs_per_round=1, batch_size=16,
             fanout=4, seed=0)
    _, plane = gnn_serve.build_plane_from_cfg(
        cfg, cache_rows=64, serve_fanout=4, batch_size=16,
        depth_schedule=[1, L], quiet=True, device="cpu")
    np.testing.assert_array_equal(preds, _offline(plane, vids))
    np.testing.assert_array_equal(depths, np.full(len(vids), L))


def test_gnn_serve_flags_default_to_the_card():
    ap_args = []
    real = gnn_serve.build_plane_from_cfg

    class Stop(Exception):
        pass

    def spy(cfg, **kw):
        ap_args.append((cfg, kw))
        raise Stop

    gnn_serve.build_plane_from_cfg = spy
    try:
        with pytest.raises(Stop):
            gnn_serve.main(["--graph", "arxiv", "--scale", "0.1"])
    finally:
        gnn_serve.build_plane_from_cfg = real
    cfg, kw = ap_args[0]
    assert kw["device"] == "cuda" and isinstance(cfg, RunConfig)
    assert dataclasses.asdict(cfg)["graph"] == "arxiv"


# -- a plane whose embeddings live on TCP embedding servers -------------------

def test_int8_versioned_gather_equals_jax_servers():
    """The serving cache's refresh (``PT_OP_VGATHER``, int8) from port
    embed servers, whose stale rows go through the fused gather + encode,
    equals the same RPCs against JAX servers (plain and device tables):
    versions, stale sets and decoded rows."""
    from repro.launch.embed_server import serve_in_thread as jembed
    from repro_torch.exchange.socket_transport import TcpTransport
    from repro_torch.launch.embed_server import serve_in_thread as tembed

    rng = np.random.default_rng(2)
    gids = rng.permutation(3000)[:777]
    vals = [torch.from_numpy(rng.standard_normal((len(gids), 16))
                             .astype(np.float32)) for _ in range(2)]
    have = np.where(np.arange(len(gids)) % 3 == 0, -1, 1)
    out = []
    for make in (lambda: tembed(3, 16, device="cpu"), lambda: jembed(3, 16),
                 lambda: jembed(3, 16, device_tables=True)):
        hs = [make() for _ in range(2)]
        try:
            t = TcpTransport(3, 16, [h.address for h in hs], codec="int8",
                             device="cpu")
            t.register(gids)
            t.write(gids, vals)
            t.write(gids[::5], [v[::5] * 2 for v in vals])
            ver, stale, rows = t.gather_versioned(gids, have)
            none = t.gather_versioned(gids, ver)
            out.append((ver, stale, rows, none))
            t.close()
        finally:
            for h in hs:
                h.stop()
    (v0, s0, r0, n0) = out[0]
    np.testing.assert_array_equal(s0, np.nonzero(v0 != have)[0])
    assert 0 < len(s0) < len(gids) and len(n0[1]) == 0
    assert all(x.shape == (0, 16) for x in n0[2])
    for v, s, r, n in out[1:]:
        np.testing.assert_array_equal(v, v0)
        np.testing.assert_array_equal(s, s0)
        for a, b in zip(r, r0):
            assert torch.equal(a, b)


def test_plane_over_tcp_equals_in_process():
    """``build_plane_from_cfg`` with two port embed servers (OPG + int8):
    the plane refreshes its cache through ``PT_OP_VGATHER`` and answers
    every query as the same RunConfig trained and served through the
    in-process transport, bit for bit."""
    from repro_torch.launch.embed_server import serve_in_thread as tembed

    servers = [tembed(3, HIDDEN, device="cpu") for _ in range(2)]
    try:
        cfg = RunConfig(graph="arxiv", scale=0.1, graph_seed=7,
                        num_clients=2, strategy="OPG",
                        overrides={"codec": "int8", "score_kind": "degree"},
                        num_layers=3, hidden=HIDDEN, epochs_per_round=1,
                        rounds=1, seed=0)
        kw = dict(cache_rows=64, serve_fanout=4, batch_size=16,
                  depth_schedule=[1, 3], quiet=True, device="cpu")
        ref, inp_plane = gnn_serve.build_plane_from_cfg(cfg, **kw)
        cfg.embed_addrs = [f"{h.host}:{h.port}" for h in servers]
        trainer, tcp_plane = gnn_serve.build_plane_from_cfg(cfg, **kw)
        rng = np.random.default_rng(8)
        vids = rng.integers(0, len(trainer.part), 96)
        thrs = rng.choice([1.0, 0.5], len(vids))
        answers = []
        for plane in (tcp_plane, inp_plane):
            rids = [plane.submit(int(v), float(t))
                    for v, t in zip(vids, thrs)]
            done = {r.rid: r for r in plane.drain()}
            answers.append([(done[r].pred, done[r].conf, done[r].depth)
                            for r in rids])
        samples = [r for r in trainer.exchange.rpc_samples
                   if r.op == "vgather"]
    finally:
        for h in servers:
            h.stop()
    assert type(trainer.exchange).__name__ == "TcpTransport"
    assert all(np.array_equal(a, b) for a, b in
               zip(trainer.params_leaves(), ref.params_leaves()))
    assert answers[0] == answers[1]
    assert samples and any(r.n_rows for r in samples)
