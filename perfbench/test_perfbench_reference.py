"""The frozen copies against the program they were copied from, the plain
reference against the port at a tiny size, the result line's schema,
and ``correct`` coming out false under the control and under each fault
a cell can have."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from perfbench import compare, harness
from perfbench.conftest import CONTROL_GRAPH, TINY_SEED, tiny
from perfbench.drivers import train
from perfbench.gen import graph as gen_graph
from perfbench.gen.partition import bfs_partition
from perfbench.reference.model import Precision, round_tf32
from perfbench.reference.sampler import Sampler
from perfbench.reference.shards import build_shards

CELLS = ["reddit-opg-int8-train", "arxiv-e-train", "reddit-d-train"]


@pytest.mark.parametrize("preset,scale", [("reddit", 0.2), ("arxiv", 0.1)])
def test_generator_and_partition_are_the_programs(preset, scale):
    from repro_torch.graphs import partition, synthetic

    n_v, deg, n_cls, feat, train_frac, hom, noise = synthetic.PRESETS[preset]
    n = max(4 * n_cls, int(n_v * scale))
    ours = gen_graph.dcsbm(n, int(n * deg / 2), n_cls, feat, train_frac, hom,
                           noise, seed=5)
    g = synthetic.make_graph(preset, scale=scale, seed=5)
    for key in ("indptr", "indices", "features", "labels", "train_mask"):
        theirs = np.asarray(getattr(g, key))
        assert ours[key].dtype == theirs.dtype
        assert np.array_equal(ours[key], theirs), key
    assert np.array_equal(bfs_partition(ours["indptr"], ours["indices"], 4,
                                        seed=3),
                          partition.bfs_partition(g, 4, seed=3))


def test_shards_and_sampler_are_the_programs(bench, data_root):
    """The reference's shards (retention, top-f % by degree, push sets)
    and its sampler's first minibatch equal the program's trainer's."""
    cell = tiny(harness.find_cell(bench, "reddit-opg-int8-train"))
    arrays = gen_graph.load(data_root, cell.config)
    ctx = harness.Ctx(cell, TINY_SEED, 0.0, False, "cpu",
                      harness.Recorder(False))
    init = train.init_leaves(cell.config, TINY_SEED, "cpu")
    tr = train.build_trainer(ctx, arrays, cell.workload["strategy"], init)
    ours = build_shards(arrays, arrays["part"], cell.workload["strategy"],
                        TINY_SEED)
    for sh, theirs in zip(ours, tr.shards):
        assert np.array_equal(sh["pull_nodes"], theirs.pull_nodes)
        assert np.array_equal(sh["push_nodes"], theirs.push_nodes)
        assert np.array_equal(sh["indptr"], theirs.indptr)
        assert np.array_equal(sh["indices"], theirs.indices)
    m = cell.config["model"]
    layers, _ = Sampler(ours[1], m["fanout"], m["num_layers"],
                        m["batch_size"], TINY_SEED, 2).epoch()[0]
    mb = next(tr.samplers[1].epoch())
    assert np.array_equal(layers[0], mb.seeds[mb.seed_mask])
    assert np.array_equal(layers[-1], mb.input_ids[: len(layers[-1])])


def check_schema(res: dict, trace: bool) -> None:
    assert list(res)[-1] == "checks"
    keys = {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert keys | ({"breakdown"} if trace else set()) == set(res)
    assert isinstance(res["correct"], bool)
    assert isinstance(res["attempted"], int) and res["attempted"] > 0
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    dev = {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["device"]) == dev | ({"busy_s", "window_s"} if trace
                                        else set())
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", CELLS)
def test_the_port_matches_the_reference(run_tiny, name):
    res = run_tiny(name)
    check_schema(res, trace=False)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    assert set(res["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run(run_tiny, name):
    res = run_tiny(name, trace=True)
    check_schema(res, trace=True)
    assert res["correct"]
    assert {"sample_share.train", "step_ms.train", "aggregate_share.train",
            "mfu.train"} <= set(res["metrics"])
    assert ("exchange_share.train" in res["metrics"]) \
        == (name != "reddit-d-train")


def test_round_tf32():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -12,
                      -3.0])
    assert round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, 1.0, -3.0]


@pytest.mark.parametrize("name", ["reddit-opg-int8-train", "arxiv-e-train",
                                  "reddit-d-train"])
def test_the_control_is_not_correct(bench, data_root, name):
    """The reference in TF32 in the program's place fails the cell's
    limits."""
    cell = tiny(harness.find_cell(bench, name), CONTROL_GRAPH)
    arrays = gen_graph.load(data_root, cell.config)
    ctx = harness.Ctx(cell, TINY_SEED, 0.0, False, "cpu",
                      harness.Recorder(False))
    init = train.init_leaves(cell.config, TINY_SEED, "cpu")
    st = train.State(arrays, init, None, train.Counts(), [], last_leaves=init)
    ref = train.reference(ctx, st)
    ctrl = train.reference(ctx, st, prec=Precision(tf32=True))
    ok, _ = harness.judge(compare.train_numbers(ctrl, ref),
                          cell.workload["limits"])
    assert not ok


# -- faults planted in the timed path -----------------------------------------

def frozen_adam(*args, **kw):
    """Adam whose step keeps the state's moments but returns the
    parameters unchanged."""
    from repro_torch.optim import optimizer

    opt = optimizer.adam(*args, **kw)

    def step(params, grads, state):
        _, state = opt.step(params, grads, state)
        return [p.detach().clone() for p in params], state

    return dataclasses.replace(opt, step=step)


def half_batch_loss(model, batch, features, caches, labels):
    """The loss over the first half of the batch's seeds."""
    from repro_torch.models import gnn

    mask = batch["seed_mask"].clone()
    n = int(mask.sum())
    mask[n // 2:] = False
    return gnn.loss_fn(model, dict(batch, seed_mask=mask), features, caches,
                       labels)


def no_exchange(client, shard, num_layers):
    """A pull that leaves the exchange out: zeros in place of the rows."""
    n = max(1, len(shard.pull_nodes))
    return [torch.zeros((n, client.hidden)) for _ in range(num_layers - 1)]


TRAIN_FAULTS = {
    "frozen_step": ("repro_torch.optim.adam", frozen_adam),
    "half_batch": ("repro_torch.core.federated.loss_fn", half_batch_loss),
    "no_exchange": ("repro_torch.core.federated.fill_cache", no_exchange),
}


#: each training cell with each fault it can have (D exchanges nothing)
BROKEN = [(name, fault) for name in ("reddit-opg-int8-train", "arxiv-e-train",
                                     "reddit-d-train")
          for fault in sorted(TRAIN_FAULTS)
          if not (fault == "no_exchange" and name == "reddit-d-train")]


@pytest.mark.parametrize("name,fault", BROKEN)
def test_a_broken_training_step_is_not_correct(run_tiny, monkeypatch, name,
                                               fault):
    target, broken = TRAIN_FAULTS[fault]
    monkeypatch.setattr(target, broken)
    res = run_tiny(name)
    assert res["correct"] is False, res["checks"]


def altered_evaluate(inner):
    """The trainer's evaluation with every prediction moved to the next
    class once a round has been evaluated: the window's rounds report a
    wrong accuracy, the first round a right one."""

    def evaluate(self, params=None):
        if not self.acc_history:
            return inner(self, params)
        model = self.model if params is None else params
        logits = model.full_propagate(self.eval_arrays, None)[-1]
        pred = ((torch.argmax(logits, dim=-1) + 1) % logits.shape[1]).numpy()
        truth = np.asarray(self.g.labels[self.eval_gids[self.test_idx]])
        return float((pred[self.test_idx] == truth).mean())

    return evaluate


@pytest.mark.parametrize("name", CELLS)
def test_an_altered_window_accuracy_is_not_correct(run_tiny, monkeypatch,
                                                   name):
    from repro_torch.core.federated import FederatedGNNTrainer

    monkeypatch.setattr(FederatedGNNTrainer, "evaluate",
                        altered_evaluate(FederatedGNNTrainer.evaluate))
    res = run_tiny(name)
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["window_acc_gap"]["value"] > \
        res["checks"]["window_acc_gap"]["limit"]
    assert res["checks"]["acc_gap"]["value"] <= \
        res["checks"]["acc_gap"]["limit"]
