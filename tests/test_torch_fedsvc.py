"""The port's federated control plane against the JAX package's: the leaf
codec, the weight wire's error feedback and the aggregation math equal
to JAX's on seeded inputs; the protocol's bodies byte-equal; the
coordinator's barrier, dropout, orphan, sampling and async cases (ports
of ``tests/test_fedsvc.py``); deployments in threads bit-equal to the
port's in-process trainer; the two mixed deployments (JAX coordinator
with port workers, port coordinator with JAX workers) bit-equal to their
references; the int8 weight wire; and the three port launchers as
processes."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import FederatedGNNTrainer as JTrainer
from repro.core import default_strategies as jstrategies
from repro.exchange import codec as jcodec
from repro.exchange.delta import LeafErrorFeedback as JLeafEF
from repro.fedsvc import aggregation as jagg
from repro.fedsvc import protocol as jprotocol
from repro.fedsvc.coordinator import CoordinatorState as JCoordState
from repro.fedsvc.coordinator import serve_in_thread as jcoord_serve
from repro.fedsvc.runtime import EvalHarness as JHarness
from repro.fedsvc.runtime import RunConfig as JRunConfig
from repro.fedsvc.worker import FedWorker as JWorker
from repro.fedsvc.worker import run_in_thread as jrun_in_thread
from repro.graphs import make_graph as jmake_graph
from repro.launch.embed_server import serve_in_thread as jembed_serve
from repro_torch.exchange import codec as tcodec
from repro_torch.exchange import wire
from repro_torch.exchange.delta import LeafErrorFeedback
from repro_torch.fedsvc import aggregation as agg
from repro_torch.fedsvc import protocol
from repro_torch.fedsvc.coordinator import CoordinatorState, serve_in_thread
from repro_torch.fedsvc.runtime import (EvalHarness, RunConfig,
                                        make_coordinator_state)
from repro_torch.fedsvc.worker import FedWorker, WorkerScenario, run_in_thread
from repro_torch.launch.embed_server import serve_in_thread as embed_serve

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LEAF = np.arange(4, dtype=np.float32)
CFG_KW = dict(graph="reddit", scale=0.05, graph_seed=3, num_clients=2,
              batch_size=64, seed=0)


def _leaves(seed, shapes=((5, 3), (7,), (32, 32), ())):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.standard_normal(s), np.float32) for s in shapes]


# -- leaf codec, error feedback and aggregation math --------------------------

@pytest.mark.parametrize("codec", ["fp32", "fp16", "int8"])
def test_leaf_codec_equals_jax(codec):
    leaves = _leaves(0)
    tensors, shapes = tcodec.encode_leaves(codec, leaves, device="cpu")
    jt, js = jcodec.encode_leaves(codec, leaves)
    assert shapes == js and len(tensors) == len(jt)
    for a, b in zip(tensors, jt):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    for back in (tcodec.decode_leaves(codec, jt, js, device="cpu"),
                 jcodec.decode_leaves(codec, tensors, shapes)):
        for a, b in zip(back, jcodec.decode_leaves(codec, jt, js)):
            assert a.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="expected"):
        tcodec.decode_leaves(codec, tensors[:-1], shapes, device="cpu")


def test_leaf_error_feedback_equals_jax():
    ef, jef = LeafErrorFeedback(), JLeafEF()
    assert ef.max_abs_residual == jef.max_abs_residual == 0.0
    for step in range(3):
        delta = _leaves(10 + step)
        comp, jcomp = ef.compensate(delta), jef.compensate(delta)
        for a, b in zip(comp, jcomp):
            np.testing.assert_array_equal(a, b)
        t, s = tcodec.encode_leaves("int8", comp, device="cpu")
        dec = tcodec.decode_leaves("int8", t, s, device="cpu")
        ef.commit(comp, dec)
        jef.commit(jcomp, jcodec.decode_leaves(
            "int8", *jcodec.encode_leaves("int8", jcomp)))
        assert ef.max_abs_residual == jef.max_abs_residual > 0
    ef.reset()
    assert ef.max_abs_residual == 0.0


def test_aggregation_math_equals_jax():
    a, b = _leaves(1), _leaves(2)
    for f, jf in ((agg.leaf_sub, jagg.leaf_sub), (agg.leaf_add,
                                                   jagg.leaf_add)):
        for x, y in zip(f(a, b), jf(a, b)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    for st, d in ((0, 0.5), (2, 0.5), (3, 0.9), (-1, 0.5), (4, 0.0)):
        assert agg.staleness_scale(st, d) == jagg.staleness_scale(st, d)
    ups = [(31.0, 1.0, _leaves(3)), (17.0, 0.5, _leaves(4)),
           (52.0, 0.25, _leaves(5))]
    for x, y in zip(agg.apply_buffered_deltas(a, ups),
                    jagg.apply_buffered_deltas(a, ups)):
        assert x.tobytes() == y.tobytes()
    zero = agg.apply_buffered_deltas(a, [(1.0, 0.0, b)])
    for x, y in zip(zero, a):
        np.testing.assert_array_equal(x, y)
    lists = [_leaves(k) for k in range(3)]
    for x, y in zip(agg.fedavg_leaves(lists, [31.0, 17.0, 52.0]),
                    jagg.fedavg_leaves(lists, [31.0, 17.0, 52.0])):
        assert x.tobytes() == y.tobytes()
    with pytest.raises(ValueError):
        agg.leaf_add(a, b[:-1])
    with pytest.raises(ValueError):
        agg.apply_buffered_deltas(a, [])


def test_protocol_bodies_equal_jax():
    leaves = _leaves(6)
    head = {"round": 3, "weight": 2.5, "client_id": 1}
    body = protocol.build_body(protocol.PT_OP_UPDATE, head, leaves)
    assert body == jprotocol.build_body(jprotocol.OP_UPDATE, head, leaves)
    for parse in (protocol.parse_body, jprotocol.parse_body):
        op, h, t = parse(body)
        assert op == protocol.PT_OP_UPDATE and h == head
        assert [x.tobytes() for x in t] == [x.tobytes() for x in leaves]
    assert protocol.build_ok({"a": 1}) == jprotocol.build_ok({"a": 1})
    assert protocol.build_err("boom") == jprotocol.build_err("boom")
    with pytest.raises(RuntimeError, match="boom"):
        protocol.parse_reply(jprotocol.build_err("boom"))
    assert protocol.parse_body(protocol.build_ok())[2] == []


# -- coordinator protocol (tiny fake workers) ---------------------------------

def _state(**kw):
    kw.setdefault("num_clients", 2)
    kw.setdefault("num_rounds", 1)
    return CoordinatorState(device="cpu", **kw)


def _wait_for(predicate, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not predicate() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert predicate()


def test_registration_and_model_roundtrip():
    state = _state()
    with serve_in_thread(state) as coord:
        init = [np.nextafter(LEAF, 100.0), np.float32(1.5).reshape(())]
        with protocol.CoordinatorClient(coord.address) as a, \
                protocol.CoordinatorClient(coord.address) as b:
            h = a.hello("w0", [0], init_leaves=init)
            assert h["mode"] == "sync" and h["round"] == 0
            with pytest.raises(RuntimeError, match="already registered"):
                b.hello("w1", [0])
            with pytest.raises(RuntimeError, match="out of range"):
                b.hello("w1", [5])
            b.hello("w1", [1])
            head, leaves = a.get_model(0)
            assert head["round"] == 0 and not head["done"]
            for x, y in zip(init, leaves):       # byte-exact round trip
                assert x.tobytes() == y.tobytes()
                assert x.dtype == y.dtype and x.shape == y.shape
            # the growth band answers in the embedding plane's layout
            wire.send_frame(a.sock, bytes([48]))
            with pytest.raises(RuntimeError, match="item 5"):
                wire.parse_response(wire.recv_frame(a.sock))


def test_sync_barrier_semantics():
    state = _state(num_rounds=2)
    with serve_in_thread(state) as coord:
        a = protocol.CoordinatorClient(coord.address)
        b = protocol.CoordinatorClient(coord.address)
        a.hello("w0", [0], init_leaves=[LEAF])
        b.hello("w1", [1])
        a.get_model(0)
        a.pulled(0, [0])
        unblocked = threading.Event()

        def waiter():
            with protocol.CoordinatorClient(coord.address) as c:
                c.wait_pulled(0)
            unblocked.set()

        threading.Thread(target=waiter, daemon=True).start()
        time.sleep(0.3)
        assert not unblocked.is_set()          # one client still missing
        b.pulled(0, [1])
        assert unblocked.wait(timeout=5.0)
        got_model = threading.Event()

        def getter():
            with protocol.CoordinatorClient(coord.address) as c:
                c.get_model(1)
            got_model.set()

        threading.Thread(target=getter, daemon=True).start()
        a.update({"round": 0, "client_id": 0, "weight": 1.0}, [LEAF])
        time.sleep(0.3)
        assert state.round == 0 and not got_model.is_set()
        b.update({"round": 0, "client_id": 1, "weight": 3.0}, [LEAF * 5])
        assert got_model.wait(timeout=5.0)
        assert state.round == 1
        np.testing.assert_array_equal(
            state.leaves[0],
            jagg.fedavg_leaves([[LEAF], [LEAF * 5]], [1.0, 3.0])[0])
        with pytest.raises(RuntimeError, match="round 0"):
            a.update({"round": 0, "client_id": 0, "weight": 1.0}, [LEAF])
        a.close()
        b.close()


def test_worker_dropout_mid_round():
    state = _state(num_rounds=2)
    with serve_in_thread(state) as coord:
        a = protocol.CoordinatorClient(coord.address)
        b = protocol.CoordinatorClient(coord.address)
        a.hello("w0", [0], init_leaves=[LEAF])
        b.hello("w1", [1])
        a.get_model(0)
        a.pulled(0, [0])
        b.pulled(0, [1])
        a.update({"round": 0, "client_id": 0, "weight": 1.0}, [LEAF + 1])
        assert state.round == 0
        b.close()                              # mid-round death
        _wait_for(lambda: state.round == 1)
        assert state.history[0]["clients"] == [0]
        np.testing.assert_array_equal(state.leaves[0], LEAF + 1)
        a.pulled(1, [0])
        a.wait_pulled(1)
        a.update({"round": 1, "client_id": 0, "weight": 1.0}, [LEAF])
        h, _ = a.get_model(2)
        assert h["done"]
        a.close()


def test_sync_orphaned_update_not_aggregated():
    state = _state(num_rounds=1)
    with serve_in_thread(state) as coord:
        a = protocol.CoordinatorClient(coord.address)
        b = protocol.CoordinatorClient(coord.address)
        a.hello("w0", [0], init_leaves=[LEAF])
        b.hello("w1", [1])
        a.get_model(0)
        a.pulled(0, [0])
        b.pulled(0, [1])
        b.update({"round": 0, "client_id": 1, "weight": 9.0}, [LEAF * 100])
        b.close()                              # dies with update pending
        _wait_for(lambda: "w1" not in state.workers)
        assert 1 not in state.updates
        a.update({"round": 0, "client_id": 0, "weight": 1.0}, [LEAF + 2])
        _wait_for(lambda: state.round == 1)
        assert state.history[0]["clients"] == [0]
        np.testing.assert_array_equal(state.leaves[0], LEAF + 2)
        a.close()


def test_sync_all_workers_drop_does_not_wedge():
    state = _state(num_rounds=1)
    with serve_in_thread(state) as coord:
        a = protocol.CoordinatorClient(coord.address)
        b = protocol.CoordinatorClient(coord.address)
        a.hello("w0", [0], init_leaves=[LEAF])
        b.hello("w1", [1])
        a.get_model(0)
        a.pulled(0, [0])
        a.update({"round": 0, "client_id": 0, "weight": 1.0}, [LEAF * 50])
        a.close()
        _wait_for(lambda: "w0" not in state.workers)
        assert 0 not in state.updates
        b.close()
        _wait_for(lambda: not state.workers)
        assert state.updates == {} and state.round == 0
        c = protocol.CoordinatorClient(coord.address)
        c.hello("w2", [0, 1])
        c.get_model(0)
        c.pulled(0, [0, 1])
        c.wait_pulled(0)
        c.update({"round": 0, "client_id": 0, "weight": 1.0}, [LEAF + 1])
        c.update({"round": 0, "client_id": 1, "weight": 1.0}, [LEAF + 3])
        _wait_for(lambda: state.round == 1)
        assert state.history[0]["clients"] == [0, 1]
        np.testing.assert_array_equal(
            state.leaves[0],
            agg.fedavg_leaves([[LEAF + 1], [LEAF + 3]], [1.0, 1.0])[0])
        c.close()


def test_hello_empty_init_refused():
    state = _state()
    with serve_in_thread(state) as coord:
        with protocol.CoordinatorClient(coord.address) as c:
            assert c.hello("w0", [0], init_leaves=[])["mode"] == "sync"
            assert state.leaves is None
            with pytest.raises(RuntimeError, match="empty init"):
                c._rpc(protocol.PT_OP_HELLO,
                       {"worker_id": "w0", "client_ids": [0],
                        "has_init": True})
            c.hello("w0", [0], init_leaves=[LEAF])
            assert state._num_params() == len(LEAF)


def test_sync_client_sampling_subset_and_eligible_only():
    state = _state(num_rounds=2, sample_frac=0.5)
    with serve_in_thread(state) as coord:
        a = protocol.CoordinatorClient(coord.address)
        b = protocol.CoordinatorClient(coord.address)
        a.hello("w0", [0], init_leaves=[LEAF])
        b.hello("w1", [1])
        stubs = {0: a, 1: b}
        for rnd in range(2):
            h, _ = a.get_model(rnd)
            assert not h["done"] and len(h["sampled"]) == 1
            cid = h["sampled"][0]
            other = 1 - cid
            stubs[other].update({"round": rnd, "client_id": other,
                                 "weight": 99.0}, [LEAF * 99])
            assert state.round == rnd          # not aggregated
            stubs[cid].pulled(rnd, [cid])
            stubs[cid].wait_pulled(rnd)
            stubs[cid].update({"round": rnd, "client_id": cid,
                               "weight": 1.0}, [LEAF + rnd])
            _wait_for(lambda: state.round == rnd + 1)
            assert state.history[rnd]["clients"] == [cid]
            np.testing.assert_array_equal(state.leaves[0], LEAF + rnd)
        assert state.done
        a.close()
        b.close()


def test_async_staleness_weights():
    state = _state(num_rounds=2, mode="async", buffer_size=2,
                   staleness_decay=0.5)
    with serve_in_thread(state) as coord:
        a = protocol.CoordinatorClient(coord.address)
        b = protocol.CoordinatorClient(coord.address)
        a.hello("w0", [0], init_leaves=[np.zeros(3, np.float32)])
        b.hello("w1", [1])
        assert a.get_model(0)[0]["version"] == 0
        one = np.ones(3, np.float32)
        a.update({"version": 0, "client_id": 0, "weight": 1.0}, [one])
        assert state.version == 0              # buffer not full yet
        b.update({"version": 0, "client_id": 1, "weight": 1.0}, [one])
        assert state.version == 1
        np.testing.assert_allclose(state.leaves[0], 1.0, rtol=1e-6)
        a.update({"version": 0, "client_id": 0, "weight": 1.0},
                 [np.full(3, 2.0, np.float32)])
        h = b.update({"version": 1, "client_id": 1, "weight": 3.0},
                     [np.zeros(3, np.float32)])
        assert h["done"] and state.version == 2
        want = jagg.apply_buffered_deltas(
            [np.ones(3, np.float32)],
            [(1.0, 0.5, [np.full(3, 2.0, np.float32)]),
             (3.0, 1.0, [np.zeros(3, np.float32)])])
        np.testing.assert_array_equal(state.leaves[0], want[0])
        assert state.history[-1]["staleness"] == [1, 0]
        a.close()
        b.close()


def test_async_sampling_rate_limits_refuses_and_redraws():
    """sample_seed=1 draws {0} at version 0: the unsampled worker's
    update is refused (no buffer, no bytes), its get_model parks, and
    when the whole sample dies the version is redrawn from the
    survivors."""
    state = _state(num_rounds=1, mode="async", buffer_size=1,
                   sample_frac=0.5, sample_seed=1)
    with serve_in_thread(state) as coord:
        a = protocol.CoordinatorClient(coord.address)
        b = protocol.CoordinatorClient(coord.address)
        a.hello("w0", [0], init_leaves=[np.zeros(3, np.float32)])
        b.hello("w1", [1])
        h, _ = a.get_model(0)
        assert h["sampled"] == [0]
        before = state.weight_bytes_cum
        h = b.update({"version": 0, "client_id": 1, "weight": 1.0},
                     [np.ones(3, np.float32)])
        assert h["accepted"] is False and state.buffer == []
        assert state.weight_bytes_cum == before
        got, unblocked = {}, threading.Event()

        def fetch():
            got["head"], _ = b.get_model(0)
            unblocked.set()

        t = threading.Thread(target=fetch, daemon=True)
        t.start()
        time.sleep(0.3)
        assert not unblocked.is_set()          # parked: {0} is sampled
        a.close()                              # the whole sample dies
        assert unblocked.wait(5.0)
        t.join()
        assert got["head"]["sampled"] == [1]   # redrawn from survivors
        h = b.update({"version": 0, "client_id": 1, "weight": 1.0},
                     [np.ones(3, np.float32)])
        assert h["accepted"] is True and h["done"]
        assert state.history[-1]["clients"] == [1]
        b.close()


# -- deployments in threads ---------------------------------------------------

def _deploy(cfg, state, make_worker, n_workers=2, timeout=120):
    with serve_in_thread(state) if isinstance(state, CoordinatorState) \
            else jcoord_serve(state) as coord:
        workers = [make_worker(i, coord.address) for i in range(n_workers)]
        threads = [(run_in_thread if isinstance(w, FedWorker)
                    else jrun_in_thread)(w) for w in workers]
        assert coord.join(timeout=timeout)
        for t in threads:
            t.join(timeout=60)
    return workers


def _port_ref(over, rounds=2, init=None):
    """The port's in-process trainer on the CPU (optionally from given
    initial leaves): accuracies and final leaves."""
    cfg = RunConfig(strategy="E", rounds=rounds, overrides=over, **CFG_KW)
    tr = cfg.build_trainer(device="cpu")
    if init is not None:
        tr.load_leaves(init)
    stats = tr.train(rounds)
    return [s.accuracy for s in stats], tr.params_leaves()


@pytest.mark.parametrize("over", [dict(codec="int8"),
                                  dict(codec="int8", error_feedback=True,
                                       delta_threshold=0.05)])
def test_port_deployment_equals_in_process(over):
    """Coordinator, 2 embed servers and 2 workers of the port in threads:
    leaves and accuracy history bit-identical to the port's in-process
    trainer over 2 shards, and each worker's records carry its phases."""
    accs, leaves = _port_ref(dict(over, num_server_shards=2))
    shards = [embed_serve(3, 32, device="cpu") for _ in range(2)]
    try:
        cfg = RunConfig(strategy="E", rounds=2, overrides=over,
                        embed_addrs=[f"{h.host}:{h.port}" for h in shards],
                        **CFG_KW)
        state = make_coordinator_state(cfg, device="cpu")
        workers = _deploy(cfg, state, lambda i, addr: FedWorker(
            cfg, [i], addr, device="cpu"))
    finally:
        for h in shards:
            h.stop()
    assert [h["accuracy"] for h in state.history] == accs
    for a, b in zip(leaves, state.leaves):
        np.testing.assert_array_equal(a, b)
    for w in workers:
        assert [r["round"] for r in w.records] == [0, 1]
        ph = w.records[0]["phases"][str(w.client_ids[0])]
        assert ph["pull_s"] > 0 and ph["train_s"] > 0
        assert ph["pull_modelled_s"] > 0 and ph["push_modelled_s"] > 0
    for h in state.history:
        assert h["round_modelled_s"] > 0 and h["wall_s"] > 0


def test_jax_coordinator_with_port_workers():
    """A JAX coordinator (JAX init leaves, JAX evaluation) and port
    workers seeded from the same leaves: FedAvg leaves bit-identical to
    the port's in-process trainer loaded with those leaves."""
    shards = [jembed_serve(3, 32)]
    try:
        jcfg = JRunConfig(strategy="E", rounds=2,
                          embed_addrs=[f"{h.host}:{h.port}" for h in shards],
                          **CFG_KW)
        harness = JHarness(jcfg)
        init = harness.init_leaves()
        accs, leaves = _port_ref({}, init=init)
        state = JCoordState(num_clients=2, num_rounds=2,
                            init_leaves=init,
                            eval_fn=harness.evaluate_leaves)
        cfg = RunConfig(strategy="E", rounds=2,
                        embed_addrs=jcfg.embed_addrs, **CFG_KW)

        def worker(i, addr):
            tr = cfg.build_trainer(only_clients=[i], device="cpu")
            tr.load_leaves(init)
            return FedWorker(cfg, [i], addr, trainer=tr)

        _deploy(cfg, state, worker)
    finally:
        for h in shards:
            h.stop()
    for a, b in zip(leaves, state.leaves):
        np.testing.assert_array_equal(a, b)
    assert len(state.history) == 2
    assert [h["accuracy"] for h in state.history] == accs


def test_port_coordinator_with_jax_workers():
    """A port coordinator seeded with the JAX trainer's leaves and JAX
    workers over port embed servers: leaves bit-identical to the JAX
    in-process trainer."""
    g = jmake_graph("reddit", scale=0.05, seed=3)
    ref = JTrainer(g, 2, jstrategies()["E"], batch_size=64, seed=0)
    init = ref.params_leaves()
    jaccs = [s.accuracy for s in ref.train(2)]
    shards = [embed_serve(3, 32, device="cpu") for _ in range(2)]
    try:
        jcfg = JRunConfig(strategy="E", rounds=2,
                          embed_addrs=[f"{h.host}:{h.port}" for h in shards],
                          **CFG_KW)
        harness = EvalHarness(RunConfig(**{**dataclasses.asdict(jcfg),
                                           "embed_addrs": []}),
                              device="cpu")
        state = CoordinatorState(num_clients=2, num_rounds=2,
                                 init_leaves=init,
                                 eval_fn=harness.evaluate_leaves,
                                 device="cpu")
        _deploy(jcfg, state, lambda i, addr: JWorker(jcfg, [i], addr))
    finally:
        for h in shards:
            h.stop()
    for a, b in zip(ref.params_leaves(), state.leaves):
        np.testing.assert_array_equal(a, b)
    assert state.acc_history == jaccs


def test_int8_weight_wire(monkeypatch):
    """Strategy D with the int8 weight codec and its error feedback: what
    the coordinator decodes from each update equals the worker's local
    round trip (the view its EF committed) bit for bit, and an update
    costs 1 B a scalar plus 4 B a leaf of payload."""
    over = {"weight_codec": "int8", "weight_error_feedback": True}
    cfg = RunConfig(strategy="D", rounds=2, overrides=over,
                    epochs_per_round=1, **CFG_KW)
    state = make_coordinator_state(cfg, device="cpu")
    committed, received = [], []
    commit = LeafErrorFeedback.commit

    def spy_commit(self, compensated, decoded):
        committed.append([np.asarray(d).copy() for d in decoded])
        return commit(self, compensated, decoded)

    monkeypatch.setattr(LeafErrorFeedback, "commit", spy_commit)
    orig = state._op_update

    def spy_update(conn_id, header, tensors):
        received.append((header, [np.asarray(t).copy() for t in tensors]))
        return orig(conn_id, header, tensors)

    state._op_update = spy_update
    workers = _deploy(cfg, state, lambda i, addr: FedWorker(
        cfg, [i], addr, worker_id=f"w{i}", device="cpu"))
    assert len(state.history) == 2 and len(received) == 4
    n_params = sum(int(np.prod(l.shape)) for l in state.leaves)
    n_leaves = len(state.leaves)
    for header, tensors in received:
        assert header["kind"] == "delta" and header["codec"] == "int8"
        assert sum(t.nbytes for t in tensors) == n_params + 4 * n_leaves
    decoded = [tcodec.decode_leaves("int8", t, h["shapes"], device="cpu")
               for h, t in received]
    key = [x.tobytes() for d in committed for x in d]
    assert sorted(key) == sorted(x.tobytes() for d in decoded for x in d)
    for w in workers:
        assert all(ef.max_abs_residual > 0 for ef in w._wef.values())
    for x in state.history:
        assert x["weight_bytes"] > 0 and x["weight_modelled_s"] > 0


def test_async_deployment_with_scenarios():
    shards = [embed_serve(3, 32, device="cpu")]
    try:
        over = {"aggregation": "async", "buffer_size": 2,
                "staleness_decay": 0.5}
        cfg = RunConfig(strategy="E", rounds=3, overrides=over,
                        epochs_per_round=1,
                        embed_addrs=[f"{h.host}:{h.port}" for h in shards],
                        **CFG_KW)
        state = make_coordinator_state(cfg, device="cpu")
        workers = _deploy(cfg, state, lambda i, addr: FedWorker(
            cfg, [i], addr, device="cpu", scenario=WorkerScenario(
                straggler_s=0.2 * (1 - i), pacing=1.0 + 0.5 * i, seed=i)))
    finally:
        for h in shards:
            h.stop()
    assert state.version == 3
    assert all("staleness" in h for h in state.history)
    assert all(r["measured_s"] >= 0.2 for r in workers[0].records)


def test_runconfig_and_refusals():
    cfg = RunConfig(strategy="OPP", rounds=5,
                    overrides={"codec": "int8", "delta_threshold": 0.05,
                               "aggregation": "async"},
                    embed_addrs=["127.0.0.1:7040"])
    back = RunConfig.from_json(cfg.to_json())
    assert back == cfg
    assert json.loads(cfg.to_json()) == json.loads(
        JRunConfig(**json.loads(cfg.to_json())).to_json())
    st = back.build_strategy()
    assert st.codec == "int8" and st.aggregation == "async"
    assert st.transport == "tcp" and st.prefetch_frac == 0.25
    with pytest.raises(NotImplementedError, match="item 4"):
        RunConfig(graph="store:/nowhere").build_graph()
    with pytest.raises(NotImplementedError, match="item 5"):
        RunConfig(growth={"scale": 1}).build_trainer(device="cpu")
    tr = RunConfig(**CFG_KW).build_trainer(only_clients=[1], device="cpu")
    with pytest.raises(RuntimeError, match="no eval"):
        tr.evaluate()
    with pytest.raises(RuntimeError, match="needs every client"):
        tr.run_round(0, 0.0)
    assert tr.samplers[0] is None and tr.samplers[1] is not None


# -- the launchers as processes -----------------------------------------------

def _read_line(proc, prefix, timeout=120.0):
    """The first stdout line starting with ``prefix`` (bounded wait)."""
    box = {}

    def reader():
        for line in proc.stdout:
            if line.startswith(prefix):
                box["line"] = line
                return

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    t.join(timeout)
    assert "line" in box, f"no {prefix!r} line within {timeout} s"
    return box["line"]


def test_launchers_as_processes(tmp_path):
    """Two embed servers, a coordinator and two workers of the port as
    processes on the CPU (port 0, addresses read from their stdout,
    every wait bounded): the accuracy history equals the deployment in
    threads, and every process exits 0."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    py = [sys.executable, "-m"]
    common = ["--graph", "reddit", "--scale", "0.05", "--graph-seed", "3",
              "--clients", "2", "--strategy", "E", "--rounds", "2",
              "--device", "cpu"]
    out_json = tmp_path / "history.json"
    procs = []
    try:
        addrs = []
        for _ in range(2):
            p = subprocess.Popen(py + ["repro_torch.launch.embed_server",
                                       "--port", "0", "--device", "cpu"],
                                 env=env, stdout=subprocess.PIPE, text=True)
            procs.append(p)
            addrs.append(_read_line(p, "embed_server listening on")
                         .split()[3])
        embeds = sum((["--embed", a] for a in addrs), [])
        coord = subprocess.Popen(
            py + ["repro_torch.launch.fed_coordinator", "--port", "0",
                  "--timeout", "120", "--linger", "0.5",
                  "--out", str(out_json)] + common + embeds,
            env=env, stdout=subprocess.PIPE, text=True)
        procs.append(coord)
        caddr = _read_line(coord, "fed_coordinator listening on").split()[3]
        workers = [subprocess.Popen(
            py + ["repro_torch.launch.fed_worker", "--coordinator", caddr,
                  "--client-ids", str(i)] + common + embeds,
            env=env, stdout=subprocess.PIPE, text=True) for i in range(2)]
        procs += workers
        _read_line(coord, "fed_coordinator DONE")
        for i, w in enumerate(workers):
            _read_line(w, f"fed_worker worker-{i} DONE")
        from repro_torch.exchange.socket_transport import TcpTransport
        TcpTransport(3, 32, addrs, device="cpu").shutdown_servers()
        for p in procs:
            assert p.wait(timeout=60) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    history = json.loads(out_json.read_text())
    accs, _ = _port_ref({})
    assert [h["accuracy"] for h in history] == accs
