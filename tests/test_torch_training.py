"""The port's training slice as a whole, held to the JAX trainer.

Both trainers run arxiv at scale 0.1 (seed 7), 2 clients, GraphConv
L = 3, hidden 16, from the JAX trainer's initial parameters, for two
rounds of each strategy: E, OPG and OPP (frequency scores, as the paper
defaults) and E with the int8 codec, error feedback and τ = 0.05 delta
pushes.

Held exactly: the shards, pull, push, retained and prefetch sets, the
dynamic-pull RPC sizes, the stored-embedding count and the transfer
log's bytes and RPCs.  Held within tolerances, per round: the training
loss (relative 1e-4 in fp32; 1e-3 with int8, where a one-ulp difference
in a summed embedding can flip one rounding of the codec) and the global
parameters (absolute 1e-4 in fp32, 1e-3 with int8): the two frameworks'
float32 products and sums add in different orders.  Accuracy differs by
at most one test vertex.  Then the port's trained state is published
and served.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.federated import FederatedGNNTrainer as JTrainer
from repro.core.strategies import default_strategies as jstrategies
from repro.gnnserve import build_serving as jbuild_serving
from repro.graphs import make_graph as jmake_graph
from repro_torch.core.federated import FederatedGNNTrainer as TTrainer
from repro_torch.core.strategies import default_strategies as tstrategies
from repro_torch.gnnserve import build_serving as tbuild_serving
from repro_torch.graphs import make_graph as tmake_graph
from repro_torch.models.gnn import from_jax_leaves

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")
torch.set_num_threads(1)

L, HIDDEN, ROUNDS = 3, 16, 2
INT8_EF_TAU = dict(codec="int8", error_feedback=True, delta_threshold=0.05)
CASES = {"E": ("E", {}), "OPG": ("OPG", {}), "OPP": ("OPP", {}),
         "E-int8-ef-tau": ("E", INT8_EF_TAU)}


def _pair(case):
    base, over = CASES[case]
    kw = dict(num_layers=L, hidden=HIDDEN, seed=0)
    jt = JTrainer(jmake_graph("arxiv", scale=0.1, seed=7), 2,
                  dataclasses.replace(jstrategies()[base], **over), **kw)
    model = from_jax_leaves(jt.params_leaves(), "graphconv", device="cpu")
    tt = TTrainer(tmake_graph("arxiv", scale=0.1, seed=7), 2,
                  dataclasses.replace(tstrategies()[base], **over),
                  model=model, device="cpu", **kw)
    return jt, tt


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
        jlog, tlog = jt.exchange.log, tt.exchange.log
        assert (tlog.bytes, tlog.rpcs, tlog.embeddings) == \
            (jlog.bytes, jlog.rpcs, jlog.embeddings)
        assert ts.train_loss == pytest.approx(js.train_loss, rel=rtol)
        assert abs(ts.accuracy - js.accuracy) <= one_vertex + 1e-12
        for a, b in zip(jt.params_leaves(), tt.params_leaves()):
            np.testing.assert_allclose(b, a, rtol=0, atol=atol)
    if case == "OPP":
        assert sum(ts.pull_rpc_sizes) > 0
    if lossy:
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


@pytest.mark.parametrize("over,kw", [
    (dict(num_server_shards=2), {}), (dict(transport="tcp"), {}),
    (dict(shard_placement="pull_frequency"), {}),
    (dict(aggregation="async"), {}), (dict(weight_codec="int8"), {}),
    (dict(sample_frac=0.5), {}), ({}, dict(only_clients=[0])),
    ({}, dict(growth=object())), ({}, dict(shards=[None, None])),
    ({}, dict(transport_addrs=[":7040"]))])
def test_unported_configurations_are_refused(over, kw):
    st = dataclasses.replace(tstrategies()["E"], **over)
    with pytest.raises(NotImplementedError, match="not ported"):
        TTrainer(tmake_graph("arxiv", scale=0.1, seed=7), 2, st,
                 device="cpu", **kw)
