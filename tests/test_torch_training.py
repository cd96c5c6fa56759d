"""The port's training slice as a whole, held to the JAX trainer.

Both trainers run arxiv at scale 0.1 (seed 7), 2 clients, GraphConv
L = 3, hidden 16, from the JAX trainer's initial parameters, for two
rounds of each strategy: E, OPG and OPP (frequency scores, as the paper
defaults), E with the int8 codec, error feedback and τ = 0.05 delta
pushes, E with int8 over 4 hashed embedding-server shards, E over 4
shards placed by pull frequency (rebalanced before round 1), and E with
SGD (momentum 0.9), AdamW and Adafactor in place of Adam.

Held exactly: the shards, pull, push, retained and prefetch sets, the
dynamic-pull RPC sizes, the stored-embedding count and every shard
log's bytes, RPCs and embeddings; with pull-frequency placement the
pull tallies and the placement map.  Held within tolerances, per round:
the training loss (relative 1e-4 in fp32; 1e-3 with int8, where a
one-ulp difference in a summed embedding can flip one rounding of the
codec) and the global parameters (absolute 1e-4 in fp32, 1e-3 with
int8): the two frameworks' float32 products and sums add in different
orders.  Accuracy differs by at most one test vertex.  Sharding the
exchange changes no number of the port's (accuracies ``==``, parameters
``torch.equal`` at 1 and 4 shards), and neither do the coordinator's
fields of a Strategy, which the in-process trainers of both packages
accept and do not read.  Then the port's trained state is published and
served.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core.federated import FederatedGNNTrainer as JTrainer
from repro.core.strategies import default_strategies as jstrategies
from repro.gnnserve import build_serving as jbuild_serving
from repro.graphs import make_graph as jmake_graph
from repro_torch.core.federated import FederatedGNNTrainer as TTrainer
from repro_torch.core.strategies import default_strategies as tstrategies
from repro_torch.gnnserve import build_serving as tbuild_serving
from repro_torch.graphs import make_graph as tmake_graph
from repro_torch import optim as toptim
from repro_torch.models.gnn import from_jax_leaves

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")
torch.set_num_threads(1)

L, HIDDEN, ROUNDS = 3, 16, 2
INT8_EF_TAU = dict(codec="int8", error_feedback=True, delta_threshold=0.05)
SHARDS4 = dict(num_server_shards=4)
#: case → (strategy, its overrides, (optimizer, args, kwargs) or None)
CASES = {"E": ("E", {}, None), "OPG": ("OPG", {}, None),
         "OPP": ("OPP", {}, None),
         "E-int8-ef-tau": ("E", INT8_EF_TAU, None),
         "E-int8-4-shards": ("E", dict(codec="int8", **SHARDS4), None),
         "E-pull-frequency-4-shards": (
             "E", dict(shard_placement="pull_frequency", **SHARDS4), None),
         "E-sgd-momentum": ("E", {}, ("sgd", (0.05,), {"momentum": 0.9})),
         "E-adamw": ("E", {}, ("adamw", (1e-2,), {})),
         "E-adafactor": ("E", {}, ("adafactor", (1e-2,), {}))}


def _pair(case):
    base, over, opt = CASES[case]
    kw = dict(num_layers=L, hidden=HIDDEN, seed=0)
    jkw, tkw = dict(kw), dict(kw)
    if opt is not None:
        name, args, okw = opt
        jkw["optimizer"] = getattr(joptim, name)(*args, **okw)
        tkw["optimizer"] = getattr(toptim, name)(*args, **okw)
    jt = JTrainer(jmake_graph("arxiv", scale=0.1, seed=7), 2,
                  dataclasses.replace(jstrategies()[base], **over), **jkw)
    model = from_jax_leaves(jt.params_leaves(), "graphconv", device="cpu")
    tt = TTrainer(tmake_graph("arxiv", scale=0.1, seed=7), 2,
                  dataclasses.replace(tstrategies()[base], **over),
                  model=model, device="cpu", **tkw)
    return jt, tt


def _shard_logs(tr):
    return [(lg.bytes, lg.rpcs, lg.embeddings)
            for lg in tr.exchange.shard_logs]


def _same_sets(jt, tt):
    np.testing.assert_array_equal(tt.part, jt.part)
    for ci in range(2):
        a, b = jt.shards[ci], tt.shards[ci]
        for f in ("indptr", "indices", "global_ids", "pull_nodes",
                  "push_nodes", "all_pull_nodes"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
        np.testing.assert_array_equal(tt.push_rows[ci], jt.push_rows[ci])
        np.testing.assert_array_equal(tt.prefetch_sets[ci],
                                      jt.prefetch_sets[ci])
    np.testing.assert_array_equal(tt.eval_gids, jt.eval_gids)


@pytest.mark.parametrize("case", list(CASES))
def test_two_rounds_match_jax(case):
    jt, tt = _pair(case)
    _same_sets(jt, tt)
    if case == "OPG":
        assert all(len(sh.pull_nodes) < len(sh.all_pull_nodes)
                   for sh in tt.shards)
    lossy = "int8" in case
    rtol, atol = (1e-3, 1e-3) if lossy else (1e-4, 1e-4)
    one_vertex = 1.0 / len(jt.test_idx)
    jt.pretrain_round()
    tt.pretrain_round()
    jcum = tcum = 0.0
    for r in range(ROUNDS):
        js, ts = jt.run_round(r, jcum), tt.run_round(r, tcum)
        jcum, tcum = js.cum_time, ts.cum_time
        assert ts.pull_rpc_sizes == js.pull_rpc_sizes
        assert ts.embeddings_stored == js.embeddings_stored
        assert _shard_logs(tt) == _shard_logs(jt)
        assert len(_shard_logs(tt)) == tt.strategy.num_server_shards
        assert ts.train_loss == pytest.approx(js.train_loss, rel=rtol)
        assert abs(ts.accuracy - js.accuracy) <= one_vertex + 1e-12
        for a, b in zip(jt.params_leaves(), tt.params_leaves()):
            np.testing.assert_allclose(b, a, rtol=0, atol=atol)
    if case == "OPP":
        assert sum(ts.pull_rpc_sizes) > 0
    if "pull-frequency" in case:
        assert tt.exchange.track_pulls and jt.exchange.track_pulls
        np.testing.assert_array_equal(tt.exchange._pull_counts,
                                      jt.exchange._pull_counts)
        np.testing.assert_array_equal(tt.exchange._placement,
                                      jt.exchange._placement)
        assert np.any(tt.exchange._placement >= 0)
    if tt.ex_clients[0].delta is not None:
        for jc, tc in zip(jt.ex_clients, tt.ex_clients):
            assert tc.delta.history == jc.delta.history


def test_trained_port_publishes_and_serves():
    jt, tt = _pair("E-int8-ef-tau")
    jt.train(1)
    tt.train(1)
    kw = dict(cache_rows=64, serve_fanout=5, batch_size=16,
              depth_schedule=[1, 3])
    tplane = tbuild_serving(tt.export_for_serving(), device="cpu", **kw)
    jplane = jbuild_serving(jt.export_for_serving(), **kw)
    vids = np.random.default_rng(3).integers(0, tt.g.num_vertices, 48)
    res = {}
    for plane in (jplane, tplane):
        rids = [plane.submit(int(v), 1.0) for v in vids]
        out = {r.rid: r for r in plane.drain()}
        assert sorted(out) == sorted(rids)
        res[plane is tplane] = out
    confs = np.array([r.conf for r in res[True].values()])
    assert np.all(np.isfinite(confs)) and np.all((confs > 0) & (confs <= 1))
    agree = np.mean([res[True][r].pred == res[False][r].pred
                     for r in res[False]])
    assert agree >= 0.95


def _port_run(over, **kw):
    """Two rounds of the port's E from the JAX trainer's initial
    parameters: (accuracies, losses, parameters)."""
    jt = JTrainer(jmake_graph("arxiv", scale=0.1, seed=7), 2,
                  jstrategies()["E"], num_layers=L, hidden=HIDDEN, seed=0)
    model = from_jax_leaves(jt.params_leaves(), "graphconv", device="cpu")
    tt = TTrainer(tmake_graph("arxiv", scale=0.1, seed=7), 2,
                  dataclasses.replace(tstrategies()["E"], **over),
                  model=model, device="cpu", num_layers=L, hidden=HIDDEN,
                  seed=0, **kw)
    stats = tt.train(ROUNDS)
    return ([s.accuracy for s in stats], [s.train_loss for s in stats],
            tt.params_leaves())


def test_sharding_never_changes_the_port_numerics():
    """E + int8 on the port at 1 and at 4 shards (the 4 behind links of
    different speeds): the same rounds, bit for bit."""
    from repro_torch.core.cost_model import NetworkModel

    one = _port_run(dict(codec="int8"))
    nets = [NetworkModel(bandwidth_bytes_per_s=b) for b in
            (125e6, 1e6, 125e6, 5e7)]
    four = _port_run(dict(codec="int8", **SHARDS4), shard_nets=nets)
    assert four[0] == one[0] and four[1] == one[1]
    for a, b in zip(one[2], four[2]):
        assert torch.equal(torch.from_numpy(a), torch.from_numpy(b))


@functools.lru_cache(maxsize=None)
def _sync_runs():
    """Two sync rounds of E on each package (shared by the cases below)."""
    kw = dict(num_layers=L, hidden=HIDDEN, seed=0)
    jt = JTrainer(jmake_graph("arxiv", scale=0.1, seed=7), 2,
                  jstrategies()["E"], **kw)
    jstats = jt.train(ROUNDS)
    return (([s.accuracy for s in jstats], jt.params_leaves()),
            _port_run({}))


@pytest.mark.parametrize("over", [dict(aggregation="async"),
                                  dict(weight_codec="int8"),
                                  dict(sample_frac=0.5)])
def test_coordinator_fields_leave_the_rounds_unchanged(over):
    """The in-process trainers of both packages accept the coordinator's
    fields of a Strategy and do not read them: the same rounds as sync,
    bit for bit, on each package."""
    (jaccs, jleaves), (taccs, tloss, tleaves) = _sync_runs()
    jt = JTrainer(jmake_graph("arxiv", scale=0.1, seed=7), 2,
                  dataclasses.replace(jstrategies()["E"], **over),
                  num_layers=L, hidden=HIDDEN, seed=0)
    assert [s.accuracy for s in jt.train(ROUNDS)] == jaccs
    for a, b in zip(jleaves, jt.params_leaves()):
        np.testing.assert_array_equal(b, a)
    accs, loss, leaves = _port_run(over)
    assert accs == taccs and loss == tloss
    for a, b in zip(tleaves, leaves):
        assert torch.equal(torch.from_numpy(a), torch.from_numpy(b))


@pytest.mark.parametrize("kw,item", [
    (dict(growth=object()), 5), (dict(shards=[None, None]), 4)])
def test_unported_configurations_are_refused(kw, item):
    """Only the graph store (item 4) and graph growth (item 5) are still
    refused; the TCP wire and shard-local trainers run
    (``tests/test_torch_wire.py``, ``tests/test_torch_fedsvc.py``)."""
    with pytest.raises(NotImplementedError,
                       match=rf"not ported.*ROADMAP\.md.*item {item}\)"):
        TTrainer(tmake_graph("arxiv", scale=0.1, seed=7), 2,
                 tstrategies()["E"], device="cpu", **kw)


@pytest.mark.parametrize("placement,match", [
    ("pull_frequency", "pull_frequency"), ("pull_freq", "shard_placement")])
def test_shard_placement_is_checked(placement, match):
    """JAX ``test_graphstore.py``'s two ValueErrors: pull-frequency
    placement needs the sharded transport, and an unknown placement is
    refused."""
    st = dataclasses.replace(tstrategies()["E"], shard_placement=placement)
    with pytest.raises(ValueError, match=match):
        TTrainer(tmake_graph("arxiv", scale=0.08, seed=3), 2, st,
                 batch_size=32, seed=0, device="cpu")
